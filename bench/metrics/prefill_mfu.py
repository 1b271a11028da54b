"""The prefill window's share of the H100's bfloat16 peak, in %: model
FLOPs of every call in the window (the forward pass at the call's length
counted from shapes, ``bench/counts.py``, the head at the last position),
over the window's seconds and 989e12."""
from bench.counts import BF16_FLOPS_PER_S


def read(run):
    w = run["window"]
    if not w.get("flops"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / BF16_FLOPS_PER_S
