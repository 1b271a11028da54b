"""The training window's share of the H100's bfloat16 peak, in %: model
FLOPs (3 x the forward pass counted from shapes, ``bench/counts.py``;
remat's recompute not counted) of every local step in the window, over
the window's seconds and 989e12."""
from bench.counts import BF16_FLOPS_PER_S


def read(run):
    w = run["window"]
    if not w.get("flops"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / BF16_FLOPS_PER_S
