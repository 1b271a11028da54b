"""Milliseconds of one FedLEO aggregation (parameters and Adam state,
eqs. 9 and 4): CUDA events around each ``aggregate`` call of the traced
run's window; total over the number of calls."""


def read(run):
    spans = run["spans"].get("aggregate_ms")
    return sum(spans) / len(spans) if spans else None
