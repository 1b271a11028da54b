"""K2's share of its roofline, in %: the frozen ``flash_bound_ms`` of each
profiled launch's shape, summed, over the profiled device time of the
flash-attention kernels."""
from bench.flash_bound import flash_bound_ms

KERNELS = ("flash_fwd_tc_kernel", "flash_fwd_kernel")


def read(run):
    prof = run.get("profile")
    shapes = run["launches"].get("flash")
    if prof is None or not shapes:
        return None
    seconds = sum(prof.seconds(k) for k in KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * sum(flash_bound_ms(*shape)[0] for shape in shapes) * 1e-3 / seconds
