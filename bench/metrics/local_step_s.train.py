"""Seconds of one ``local_step`` call of the orbit-replica driver (both
replicas' train steps): the host clock around each call of the traced
run's window, ending in a synchronise; total over the number of calls."""


def read(run):
    spans = run["spans"].get("local_step_s")
    return sum(spans) / len(spans) if spans else None
