"""Peak device memory of the training window, in GB (1e9 bytes):
``max_memory_allocated`` over the window after a reset at its start."""


def read(run):
    peak = run["memory"].get("window_peak_bytes")
    return peak / 1e9 if peak else None
