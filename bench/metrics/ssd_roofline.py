"""K3's share of its roofline, in %: the frozen ``ssd_bound_ms`` of each
profiled launch's shape, summed, over the profiled device time of the
SSD scan kernels."""
from bench.counts import ssd_bound_ms

KERNELS = ("ssd_scan_tc_kernel", "ssd_scan_kernel")


def read(run):
    prof = run.get("profile")
    shapes = run["launches"].get("ssd")
    if prof is None or not shapes:
        return None
    seconds = sum(prof.seconds(k) for k in KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * sum(ssd_bound_ms(*shape)[0] for shape in shapes) * 1e-3 / seconds
