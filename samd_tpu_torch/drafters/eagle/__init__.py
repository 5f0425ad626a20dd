"""The EAGLE draft net and its drafters (counterpart of
``samd_tpu/drafters/eagle``)."""
