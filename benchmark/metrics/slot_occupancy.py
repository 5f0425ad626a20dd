"""Live slot-steps over B x decode steps, over the window's segments."""


def read(view):
    steps = sum(s.steps for s in view.segments)
    if not steps:
        return None
    live = sum(int(s.live[s.actives].sum()) for s in view.segments)
    return 100.0 * live / (view.B * steps)
