"""The serving benchmark of ``samd_tpu_torch`` (see ``README.md``).

Everything here measures the PyTorch and CUDA package only.  No module of
this package imports ``jax``, ``jaxlib``, ``flax`` or ``samd_tpu`` (the JAX
package), and ``benchmark/reference`` imports nothing of ``samd_tpu_torch``.
"""
