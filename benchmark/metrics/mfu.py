"""The model operations of every forward in the traced sub-window over its
wall and the bf16 peak (``roofline.work``: routed experts only, no
embedding lookup)."""


def read(view):
    if view.trace is None or not view.traced_work.decode_steps:
        return None
    return 100.0 * view.traced_work.mfu(view.trace.window_s)
