"""K4's share of its roofline: the least time of the traced decode steps'
attention over each live slot's int8 columns and scales
(``roofline.work``), over the device time of the kernel named here."""

KERNELS = "paged_block_attention_kernel"


def read(view):
    if view.trace is None:
        return None
    t = view.trace.seconds_of(KERNELS)
    if t <= 0 or not view.traced_work.paged_attention_bound_s:
        return None
    return 100.0 * view.traced_work.paged_attention_bound_s / t
