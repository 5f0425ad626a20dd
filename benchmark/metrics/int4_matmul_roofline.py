"""K3's share of its roofline: the least time of every dense int4 weight
product the traced sub-window's forwards needed, at their live row counts
(``roofline.work``), over the device time of the kernels named here."""

KERNELS = "int4_matmul"      # int4_matmul_mma_kernel, _sum_kernel, _fma_kernel


def read(view):
    if view.trace is None:
        return None
    t = view.trace.seconds_of(KERNELS)
    if t <= 0 or not view.traced_work.int4_bound_s:
        return None
    return 100.0 * view.traced_work.int4_bound_s / t
