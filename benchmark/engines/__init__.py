"""Serving engines of the port, one file each, named by a config's
``serving.engine``: ``build(model_cfg, params, serving, corpus, device)``."""
