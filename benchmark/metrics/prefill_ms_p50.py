"""Median wall of the window's prefills (each waited for on the device)."""

import statistics


def read(view):
    if not view.prefills:
        return None
    return 1e3 * statistics.median(p.t1 - p.t0 for p in view.prefills)
