"""Weight routes, one file each, named by a config's ``weights.route``:
``build(cfg, model_cfg, seed, device)`` returns the program's parameters,
made from ``harness.draws`` on the device."""
