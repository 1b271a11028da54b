"""Share of the traced window in which no operation ran on the device,
in %: 1 - the union of the device's operation intervals over the
window's length (the profiler's lead-in spin kernels left out)."""


def read(run):
    prof = run.get("profile")
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
