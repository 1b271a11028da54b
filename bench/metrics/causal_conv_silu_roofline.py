"""K4's share of its roofline, in %: the frozen ``causal_conv_silu_bound_ms``
of each profiled launch's shape, summed, over the profiled device time of
the fused conv's kernel."""
from bench.counts import causal_conv_silu_bound_ms

KERNEL = "causal_conv_silu_kernel"


def read(run):
    prof = run.get("profile")
    shapes = run["launches"].get("causal_conv_silu")
    if prof is None or not shapes:
        return None
    seconds = prof.seconds(KERNEL)
    if seconds <= 0:
        return None
    return 100.0 * sum(causal_conv_silu_bound_ms(*shape)[0] for shape in shapes) * 1e-3 / seconds
