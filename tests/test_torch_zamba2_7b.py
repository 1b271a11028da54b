"""The port's published Zamba2 layout (``Zamba2SharedBlocksModel``,
zamba2-7b) against the benchmark's plain reference
(``bench/reference/zamba2.py``), on the CPU, at the ``hybrid`` family's
small size: 7 layers of d_model 64, two shared blocks used at three
uneven layers, 2 B/C groups, weights drawn from a seed by
``bench/weights.py``.  zamba2-7b has no twin in the JAX package.

Tolerances, float32 on both sides: the logits within 1e-5 of the
largest (the same products in another order and blocking: the program's
chunked scan against the reference's segment sums, its attention against
the reference's blocks of queries); the loss within 1e-5 nats and each
gradient within 1e-4 of its largest element (the backward pass sums
over more terms, through the scan's exponentials).  The fp8 control (the
reference with every product's operands in float8) fails the logits'
limit by far, and so do the pieces the layout adds, left out one at a
time.
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness, weights  # noqa: E402
from bench.reference import model as rm  # noqa: E402
from bench.reference import zamba2 as rz  # noqa: E402
from bench.tests.smoke import small_cell  # noqa: E402

from repro_torch.configs import ARCH_IDS, build_model, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402
from repro_torch.models.layers import apply_glu_ffn, apply_rope, attention_scores  # noqa: E402

LOGITS = 1e-5
CELL = "prefill.zamba2-7b"


def _cfg():
    return small_cell(CELL).config


def _program(cfg, **kw):
    return build_model(harness.program_config(cfg, remat=False), dtype=torch.float32,
                       device="cpu", **kw)


def _tokens(cfg, b, s, seed):
    return torch.randint(0, cfg["vocab_size"], (b, s), generator=torch.Generator().manual_seed(seed))


def _rel(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


# (attn_impl, ssd_impl, S): the kernels' routes at a ragged S too; the plain
# chunked scan takes whole chunks
@pytest.mark.parametrize("attn_impl,ssd_impl,s", [("pallas", "pallas", 40),
                                                  ("pallas", "pallas", 48),
                                                  ("xla", "xla", 48), ("chunked", "xla", 48)])
def test_prefill_logits_match_reference(attn_impl, ssd_impl, s):
    from repro_torch.train.steps import make_prefill_step

    cfg = _cfg()
    params = weights.make(cfg, 21, torch.float32, "cpu")
    tokens = _tokens(cfg, 3, s, 1)
    model = _program(cfg, attn_impl=attn_impl, ssd_impl=ssd_impl)
    assert isinstance(model, hybrid.Zamba2SharedBlocksModel)
    got = make_prefill_step(model)(params, {"tokens": tokens})
    want = rm.last_logits(params, tokens, cfg, rz.blocks)
    assert _rel(got, want) <= LOGITS


def test_prefill_then_decode_matches_reference_forward():
    """A prefill of 40 tokens, then 4 decode steps through the cache (one
    KV cache per use, the SSM and conv states): each step's logits
    against the reference's full forward over the prompt so far."""
    cfg = _cfg()
    params = weights.make(cfg, 22, torch.float32, "cpu")
    tokens = _tokens(cfg, 2, 44, 2)
    model = _program(cfg, attn_impl="pallas", ssd_impl="pallas")
    cache = model.init_cache(2, 44, torch.float32)
    for t in range(40):                                # the prompt, through the cache
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache, t)
    assert cache["attn"].index.tolist() == [40] * 3
    want = rm.last_logits(params, tokens[:, :40], cfg, rz.blocks)
    assert _rel(logits[:, 0], want) <= LOGITS
    for t in range(40, 44):
        logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache, t)
        want = rm.last_logits(params, tokens[:, :t + 1], cfg, rz.blocks)
        assert _rel(logits[:, 0], want) <= LOGITS, t


def test_loss_and_gradients_match_reference():
    from repro_torch.train import steps

    cfg = _cfg()
    params = weights.make(cfg, 23, torch.float32, "cpu")
    tokens = _tokens(cfg, 2, 48, 3)
    (_, ce), grads = steps._value_and_grad(steps._loss_fn(_program(cfg)), params,
                                           {"tokens": tokens})
    loss, ref_grads = rm.loss_and_grads(params, tokens, cfg, rz.blocks)
    assert abs(float(ce) - float(loss)) <= 1e-5
    got = dict(rm.leaf_items(grads))
    assert set(got) == set(ref_grads)
    for k, g in ref_grads.items():
        assert float(g.abs().max()) > 0, k                   # every leaf is on the path
        assert float((got[k] - g).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-9, k


def test_fp8_control_fails_the_logits_limit():
    cfg = _cfg()
    params = weights.make(cfg, 24, torch.float32, "cpu")
    tokens = _tokens(cfg, 4, 48, 4)
    want = rm.last_logits(params, tokens, cfg, rz.blocks)
    control = rm.last_logits(params, tokens, cfg, rz.blocks, rm.fp8)
    assert _rel(control, want) > 100 * LOGITS


@pytest.mark.parametrize("change", ["no_concat", "no_adapter", "residual_t", "one_block",
                                    "whole_row_norm", "interleaved_rope"])
def test_each_piece_of_the_layout_moves_the_logits(change, monkeypatch):
    """The reference with one piece of the published layout altered reads
    far outside the logits' limit: each piece is computed, not left to
    the tolerance."""
    cfg = dict(_cfg())
    params = weights.make(cfg, 25, torch.float32, "cpu")
    tokens = _tokens(cfg, 2, 48, 5)
    want = rm.last_logits(params, tokens, cfg, rz.blocks)
    if change == "no_concat":                       # the embeddings left out of the input
        shared = rz.shared_block
        monkeypatch.setattr(rz, "shared_block", lambda sp, up, x, emb, c, prec: shared(
            sp, up, x, torch.zeros_like(emb), c, prec))
    elif change == "no_adapter":
        params = dict(params, uses=dict(params["uses"], adapter={
            k: torch.zeros_like(v) for k, v in params["uses"]["adapter"].items()}))
    elif change == "residual_t":                    # t added to the residual too
        def layer(mp, sp, up, x, emb, c, prec):
            u = x if sp is None else x + rz.shared_block(sp, up, x, emb, c, prec)
            return u + rz.mixer(mp, rm.rmsnorm(u, mp["norm"]["scale"], c["rms_norm_eps"]),
                                 c, prec)
        monkeypatch.setattr(rz, "hybrid_layer", layer)
    elif change == "one_block":
        cfg["num_mem_blocks"] = 1
    elif change == "whole_row_norm":
        monkeypatch.setattr(rz, "group_rmsnorm", lambda y, s, e, g: rm.rmsnorm(y, s, e))
    else:
        monkeypatch.setattr(rz, "rope_half", lambda x, theta: apply_rope(
            x, torch.arange(x.shape[1]).expand(x.shape[0], -1), theta))
    assert _rel(rm.last_logits(params, tokens, cfg, rz.blocks), want) > 100 * LOGITS


def test_arch_ids_stay_the_jax_packages_and_zamba2_7b_is_found():
    assert "zamba2-7b" not in ARCH_IDS and len(ARCH_IDS) == 10
    full, smoke = get_config("zamba2-7b"), get_smoke_config("zamba2-7b")
    assert full.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)
    assert full.head_dim == 224 and full.ssm.num_groups == 2 and full.rms_norm_eps == 1e-5
    assert smoke.num_mem_blocks == 2 and len(smoke.hybrid_layer_ids) == 3
    model = build_model(full, ssd_impl="pallas", device="cpu")       # no weights drawn
    assert isinstance(model, hybrid.Zamba2SharedBlocksModel) and model.n_attn_uses == 13
    assert not isinstance(build_model(get_config("zamba2-1.2b"), device="cpu"),
                          hybrid.Zamba2SharedBlocksModel)


def test_model_init_has_the_benchmark_layout():
    """``init`` draws the tree that ``bench/weights.py`` lays out for the
    family, leaf for leaf, at the smoke size (which is the family's small
    size)."""
    cfg = _cfg()
    model = _program(cfg)
    mine = dict(rm.leaf_items(model.init(torch.Generator().manual_seed(0))))
    drawn = dict(rm.leaf_items(weights.make(cfg, 1, torch.float32, "cpu")))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in drawn.items()}
    assert harness.program_config(cfg, remat=False) == get_smoke_config("zamba2-7b")


def test_rotate_half_rope_matches_the_published_formula():
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 9, 3, 8), generator=gen)
    pos = torch.arange(9).expand(2, 9)
    got = apply_rope(x, pos, 500.0, half=True)
    assert torch.allclose(got, rz.rope_half(x, 500.0), atol=1e-6)
    assert torch.equal(apply_rope(x, pos, 500.0), apply_rope(x, pos, 500.0, half=False))
    assert not torch.allclose(got, apply_rope(x, pos, 500.0), atol=1e-3)


def test_exact_gelu_and_attention_scale_are_options():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((2, 5, 8), generator=gen)
    p = {k: torch.randn(s, generator=gen) for k, s in
         (("w_gate", (8, 16)), ("w_up", (8, 16)), ("w_down", (16, 8)))}
    exact = apply_glu_ffn(p, x, "gelu_exact")
    assert torch.allclose(exact, (torch.nn.functional.gelu(x @ p["w_gate"]) * (x @ p["w_up"]))
                          @ p["w_down"], atol=1e-5)
    assert not torch.allclose(exact, apply_glu_ffn(p, x, "gelu"), atol=1e-6)
    q, k, v = (torch.randn((1, 6, 2, 4), generator=gen) for _ in range(3))
    mask = torch.ones((1, 6, 6), dtype=torch.bool).tril()
    assert torch.equal(attention_scores(q, k, v, mask, 1),
                       attention_scores(q, k, v, mask, 1, scale=0.5))
    assert not torch.allclose(attention_scores(q, k, v, mask, 1),
                              attention_scores(q, k, v, mask, 1, scale=0.3))


def test_grouped_gated_norm_normalises_each_group():
    from repro_torch.kernels.mamba_fused_ref import gated_rmsnorm_ref

    gen = torch.Generator().manual_seed(8)
    y = torch.randn((2, 3, 32), generator=gen)
    y[..., 16:] *= 10.0
    scale = torch.rand((32,), generator=gen) + 0.5
    got = gated_rmsnorm_ref(y, scale, eps=1e-5, group_size=16)
    for g in range(2):
        part = y[..., 16 * g:16 * (g + 1)]
        want = part * torch.rsqrt((part * part).mean(-1, keepdim=True) + 1e-5) \
            * scale[16 * g:16 * (g + 1)]
        assert torch.allclose(got[..., 16 * g:16 * (g + 1)], want, atol=1e-6)
    assert torch.equal(gated_rmsnorm_ref(y, scale, group_size=32), gated_rmsnorm_ref(y, scale))


def test_prefill_records_the_shared_blocks_spans():
    """Under the tracer a prefill records ``hybrid.shared`` once a use
    (attrs ``use`` and ``block``, the blocks taken in turn) around
    ``hybrid.attn``, ``hybrid.mlp`` and ``hybrid.linear``, and
    ``mamba.block`` on every layer."""
    from repro_torch import profiling
    from repro_torch.train.steps import make_prefill_step

    cfg = _cfg()
    params = weights.make(cfg, 26, torch.float32, "cpu")
    step = make_prefill_step(_program(cfg, attn_impl="pallas", ssd_impl="pallas"))
    with profiling.recording("cpu") as rec:
        step(params, {"tokens": _tokens(cfg, 2, 32, 6)})
    spans = rec.records()
    shared = [r for r in spans if r["name"] == "hybrid.shared"]
    assert [(r["attrs"]["use"], r["attrs"]["block"]) for r in shared] == [(0, 0), (1, 1), (2, 0)]
    for r in shared:
        kids = [c["name"] for c in spans if c["parent"] == r["id"]]
        assert kids == ["hybrid.attn", "hybrid.mlp", "hybrid.linear"]
    assert [r["attrs"]["layer"] for r in spans if r["name"] == "mamba.block"] == list(range(7))
