"""Host wall of the window's segments (each ends in its host read) over
their decode steps."""


def read(view):
    steps = sum(s.steps for s in view.segments)
    if not steps:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in view.segments) / steps
