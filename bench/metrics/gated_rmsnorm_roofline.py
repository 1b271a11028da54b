"""K5's share of its roofline, in %: the frozen ``gated_rmsnorm_bound_ms``
of each profiled launch's shape, both uses (gated, and the block's input
norm) summed, over the profiled device time of the fused norm's kernel."""
from bench.counts import gated_rmsnorm_bound_ms

KERNEL = "gated_rmsnorm_kernel"


def read(run):
    prof = run.get("profile")
    shapes = run["launches"].get("gated_rmsnorm")
    if prof is None or not shapes:
        return None
    seconds = prof.seconds(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * sum(gated_rmsnorm_bound_ms(*shape)[0] for shape in shapes) * 1e-3 / seconds
