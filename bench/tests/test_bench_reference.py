"""The plain reference against the program on the CPU, in float32, at
a small size of the configuration: the forward pass, the loss and its
gradients, the SSD scan against its recurrence, and the FedLEO local
steps and aggregation against ``make_fedleo_local_step`` and
``make_fedleo_aggregate``."""
import ast
from pathlib import Path

import pytest
import torch

from bench import harness, weights
from bench.drivers import fedleo_train
from bench.reference import model as rm
from bench.reference import train as rt
from bench.tests.smoke import small_cell

CELLS = ["prefill.mamba2-780m"]
REFERENCE = Path(rm.__file__).parent


def program(cfg, **kw):
    from repro_torch.configs import build_model

    return build_model(harness.program_config(cfg, remat=False), dtype=torch.float32,
                       device="cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("s", [40, 48])
def test_last_logits_match_program(name, s):
    from repro_torch.train.steps import make_prefill_step

    cell = small_cell(name)
    cfg = cell.config
    params = weights.make(cfg, 11, torch.float32, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, s), generator=torch.Generator().manual_seed(1))
    got = make_prefill_step(program(cfg, ssd_impl="pallas", attn_impl="pallas"))(
        params, {"tokens": tokens})
    want = rm.last_logits(params, tokens, cfg, cell.family.reference.blocks)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_grads_match_program(name):
    from repro_torch.train import steps

    cell = small_cell(name)
    cfg = cell.config
    params = weights.make(cfg, 12, torch.float32, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (2, 48), generator=torch.Generator().manual_seed(2))
    (_, ce), grads = steps._value_and_grad(steps._loss_fn(program(cfg)), params,
                                           {"tokens": tokens})
    loss, ref_grads = rm.loss_and_grads(params, tokens, cfg, cell.family.reference.blocks)
    assert abs(float(ce) - float(loss)) <= 1e-5
    got = dict(rm.leaf_items(grads))
    assert set(got) == set(ref_grads)
    for k, g in ref_grads.items():
        assert float((got[k] - g).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-9, k


@pytest.mark.parametrize("s,chunk", [(37, 8), (32, 16), (5, 16)])
def test_ssd_scan_is_the_recurrence(s, chunk):
    g = torch.Generator().manual_seed(s)
    b, h, p, groups, n = 2, 4, 3, 2, 5
    x = torch.randn(b, s, h, p, generator=g, dtype=torch.float64)
    dt = torch.rand(b, s, h, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(h, generator=g, dtype=torch.float64) * 2
    Bm = torch.randn(b, s, groups, n, generator=g, dtype=torch.float64)
    Cm = torch.randn(b, s, groups, n, generator=g, dtype=torch.float64)
    state = torch.zeros(b, h, p, n, dtype=torch.float64)
    want = []
    for t in range(s):
        Bh = Bm[:, t].repeat_interleave(h // groups, dim=1)
        Ch = Cm[:, t].repeat_interleave(h // groups, dim=1)
        state = state * torch.exp(dt[:, t] * A)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * Bh[:, :, None, :]
        want.append(torch.einsum("bhn,bhpn->bhp", Ch, state))
    got = rm.ssd_scan(x, dt, A, Bm, Cm, chunk)
    assert torch.allclose(got, torch.stack(want, dim=1), atol=1e-10, rtol=1e-9)


@pytest.mark.parametrize("name", ["fedleo_train.mamba2-780m"])
def test_follow_matches_fedleo_local_steps(name):
    """Three local steps of two replicas with an aggregation after the
    second, float32 on both sides: the reference's losses, first
    gradients and changes equal the program's to rounding."""
    from repro_torch.optim import adam
    from repro_torch.train import fedleo_step, steps

    cell = small_cell(name)
    cfg, tf = cell.config, cell.traffic
    p0 = weights.make(cfg, 13, torch.float32, "cpu")
    opt = adam(cfg["train"]["learning_rate"])
    state = fedleo_step.replicate_for_orbits(steps.TrainState(
        p0, opt.init(p0), torch.zeros((), dtype=torch.int32)), tf["replicas"])
    local = fedleo_step.make_fedleo_local_step(program(cfg), opt, grad_clip=tf["grad_clip"])
    agg = fedleo_step.make_fedleo_aggregate(use_kernel=True)
    feed = fedleo_train.batches(cfg, tf, 13, torch.device("cpu"))
    fed, prog = [], {"loss": []}
    for t in range(3):
        batch = next(feed)
        state, m = local(state, batch)
        fed.append(batch["tokens"][:, 0])
        prog["loss"].append([float(x) for x in m["loss"]])
        if t == 0:
            prog["grad_norm"] = [{k: v / 0.1 for k, v in r.items()}
                                 for r in fedleo_train.leaf_norms(state.opt_state.mu)]
        if t == 1:
            state = agg(state, torch.ones(tf["replicas"]))
    prog["change_norm"] = fedleo_train.leaf_norms(state.params, p0)
    ref = rt.follow(dict(rm.leaf_items(p0)), fed, cfg, tf, cell.family.reference.blocks)
    for ps, rs in zip(prog["loss"], ref["loss"]):
        assert ps == pytest.approx(rs, abs=1e-5)
    for key in ("grad_norm", "change_norm"):
        for p, r in zip(prog[key], ref[key]):
            for k in r:
                assert p[k] == pytest.approx(r[k], rel=2e-3, abs=1e-7), (key, k)


def test_fp8_rounds_operands_to_three_and_gradients_to_two_mantissa_bits():
    x = torch.linspace(-3, 3, 1001, requires_grad=True)
    q = rm.fp8(x)
    rel = ((q.detach() - x.detach()).abs() / x.detach().abs().clamp(min=0.1)).max()
    assert 0.01 < float(rel) <= 2 ** -4 + 1e-6
    g = torch.linspace(-1, 1, 1001)
    q.backward(g)
    grel = ((x.grad - g).abs() / g.abs().clamp(min=0.05)).max()
    assert 2 ** -4 < float(grel) <= 2 ** -3 + 1e-6


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", *harness.FORBIDDEN), (path, n)
