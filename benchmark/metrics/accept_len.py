"""Tokens committed per live slot-step, over the window's segments
(output tokens / ``stats_live_steps``)."""


def read(view):
    steps = sum(int(s.live[s.actives].sum()) for s in view.segments)
    if not steps:
        return None
    made = sum(int((s.hist1 - s.hist0)[s.actives].sum())
               for s in view.segments)
    return made / steps
