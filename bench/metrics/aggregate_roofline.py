"""K1's share of its roofline, in %: the frozen ``aggregate_bound_ms`` of
each tree the profiled aggregation sent through K1 (its K, N and
itemsize), summed, over the profiled device time of K1's kernel."""
from bench.counts import aggregate_bound_ms

KERNEL = "aggregate_leaves_kernel"


def read(run):
    prof = run.get("profile")
    trees = run["launches"].get("aggregate")
    if prof is None or not trees:
        return None
    seconds = prof.seconds(KERNEL)
    if seconds <= 0:
        return None
    bound_ms = sum(aggregate_bound_ms(k, n, itemsize)[0] for k, n, itemsize in trees)
    return 100.0 * bound_ms * 1e-3 / seconds
