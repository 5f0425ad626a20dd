"""1 - the union of the device's kernel intervals over the traced
sub-window's wall."""


def read(view):
    if view.trace is None or view.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
