"""Decode steps per segment, that is per host read of the control
state, over the window."""


def read(view):
    if not view.segments:
        return None
    return sum(s.steps for s in view.segments) / len(view.segments)
