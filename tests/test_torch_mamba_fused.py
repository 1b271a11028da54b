"""The dispatch of the Mamba2 block's fused elementwise chains on the CPU.

``mamba_fused_ops`` sends CPU tensors to the plain chains, which must
compute what the block computed before the kernels existed, to the bit
(the chains below are the block's as they were, written out); it refuses
autograd and devices it has no path for; and only a prefill with
``ssd_impl="pallas"`` reaches it: training and decode never do.  The
kernels themselves run on the card only (``tests/test_torch_kernels_cuda.py``).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import build_model, get_smoke_config
from repro_torch.kernels import mamba_fused, mamba_fused_ops
from repro_torch.models import mamba2, nn
from repro_torch.models.mamba2 import _causal_conv, _dims, _split_proj

ARCHS = ["mamba2-780m", "zamba2-1.2b"]
DTYPES = [torch.float32, torch.bfloat16]
SIZES = [(1, 1), (2, 3), (2, 37)]


def _block_inputs(arch, size, dtype, seed=0):
    """A smoke config's in_proj output and parameters, in ``dtype``."""
    cfg = get_smoke_config(arch)
    d_inner, heads, g, n, c = _dims(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = mamba2.init_mamba_block(gen, cfg)
    params = {k: (v if isinstance(v, dict) else v + 0.1 * torch.randn(v.shape, generator=gen))
              for k, v in params.items()}
    params = nn.tree_cast(params, dtype)
    proj = torch.randn((*size, 2 * d_inner + 2 * g * n + heads), generator=gen).to(dtype)
    return cfg, params, proj


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_conv_on_cpu_is_the_blocks_chain_to_the_bit(arch, dtype, size):
    cfg, params, proj = _block_inputs(arch, size, dtype)
    d_inner, _, _, _, c = _dims(cfg)
    _, xin, Bm, Cm, _ = _split_proj(cfg, proj)
    conv_out, _ = _causal_conv(torch.cat([xin, Bm, Cm], dim=-1), params["conv_w"],
                               params["conv_b"], None)
    want = F.silu(conv_out)
    got = mamba_fused_ops.causal_conv_silu(proj[..., d_inner: d_inner + c], params["conv_w"],
                                           params["conv_b"])
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_norms_on_cpu_are_the_blocks_chains_to_the_bit(arch, dtype, size):
    cfg, params, proj = _block_inputs(arch, size, dtype)
    d_inner, heads, _, _, c = _dims(cfg)
    b, s = size
    gen = torch.Generator().manual_seed(1)
    z = _split_proj(cfg, proj)[0]
    conv_out = torch.randn((b, s, c), generator=gen).to(dtype)
    xh = conv_out[..., :d_inner].reshape(b, s, heads, cfg.ssm.head_dim)
    y = torch.randn((b, s, heads, cfg.ssm.head_dim), generator=gen).to(dtype)
    want = y + params["D"][None, None, :, None].to(y.dtype) * xh
    want = want.reshape(b, s, d_inner)
    want = want * F.silu(z)
    want = nn.apply_rmsnorm(params["out_norm"], want)
    got = mamba_fused_ops.gated_rmsnorm(y.reshape(b, s, d_inner), params["out_norm"]["scale"],
                                        x=conv_out[..., :d_inner], D=params["D"], z=z)
    assert got.dtype == dtype and torch.equal(got, want)

    x = torch.randn((b, s, cfg.d_model), generator=gen).to(dtype)
    got = mamba_fused_ops.gated_rmsnorm(x, params["norm"]["scale"])
    assert torch.equal(got, nn.apply_rmsnorm(params["norm"], x))


def test_fused_ops_refuse_autograd():
    """Under grad mode an input that requires grad raises; under
    ``no_grad`` the same call runs."""
    cfg, params, proj = _block_inputs("mamba2-780m", (1, 8), torch.float32)
    d_inner, _, _, _, c = _dims(cfg)
    xbc = proj[..., d_inner: d_inner + c]
    conv = (xbc, params["conv_w"], params["conv_b"])
    for i in range(3):
        args = list(conv)
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            mamba_fused_ops.causal_conv_silu(*args)
        with torch.no_grad():
            mamba_fused_ops.causal_conv_silu(*args)
    y = proj[..., :d_inner].contiguous()
    norm = dict(y=y, scale=params["out_norm"]["scale"], x=y, D=params["D"], z=y)
    for key in norm:
        kw = dict(norm, **{key: norm[key].clone().requires_grad_(True)})
        with pytest.raises(RuntimeError, match="no backward"):
            mamba_fused_ops.gated_rmsnorm(**kw)
        with torch.no_grad():
            mamba_fused_ops.gated_rmsnorm(**kw)


def test_fused_ops_refuse_other_devices():
    x = torch.empty((1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="no causal_conv_silu path"):
        mamba_fused_ops.causal_conv_silu(x, torch.empty((4, 16), device="meta"),
                                         torch.empty((16,), device="meta"))
    with pytest.raises(ValueError, match="no gated_rmsnorm path"):
        mamba_fused_ops.gated_rmsnorm(x, torch.empty((16,), device="meta"))


def test_kernel_wrappers_take_cuda_tensors_only():
    """The wrappers raise on a CPU tensor before building or launching
    anything."""
    x = torch.zeros((1, 4, 16))
    def counts():
        return (mamba_fused.causal_conv_silu.launches, mamba_fused.gated_rmsnorm.launches,
                mamba_fused.gated_rmsnorm.norm_launches)

    before = counts()
    with pytest.raises(ValueError, match="CUDA"):
        mamba_fused.causal_conv_silu(x, torch.zeros((4, 16)), torch.zeros((16,)))
    with pytest.raises(ValueError, match="CUDA"):
        mamba_fused.gated_rmsnorm(x, torch.zeros((16,)))
    assert counts() == before


@pytest.fixture
def fused_calls(monkeypatch):
    """Counts the calls into ``mamba_fused_ops``, by function."""
    calls = {"causal_conv_silu": 0, "gated_rmsnorm": 0}

    def counted(name):
        fn = getattr(mamba_fused_ops, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(mamba_fused_ops, name, counted(name))
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_only_the_kernel_prefill_reaches_the_fused_ops(arch, fused_calls):
    """A prefill with ``ssd_impl="pallas"`` calls the conv once and the
    norm twice per Mamba layer; with ``ssd_impl="xla"``, a training step
    and a decode step never call them."""
    from repro_torch.optim import get_optimizer
    from repro_torch.train import steps

    cfg = get_smoke_config(arch)
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(3))
    for impl in ("xla", "pallas"):
        model = build_model(cfg, device="cpu", ssd_impl=impl, attn_impl=impl,
                            dtype=torch.float32)
        params = model.init(torch.Generator().manual_seed(0))
        steps.make_prefill_step(model)(params, {"tokens": tokens})
        want = cfg.num_layers if impl == "pallas" else 0
        assert fused_calls == {"causal_conv_silu": want, "gated_rmsnorm": 2 * want}
        fused_calls.update(causal_conv_silu=0, gated_rmsnorm=0)

        if impl == "pallas":
            cache = model.init_cache(2, 16, dtype=torch.float32)
            steps.make_serve_step(model)(params, tokens[:, :1], cache, 0)
            assert fused_calls == {"causal_conv_silu": 0, "gated_rmsnorm": 0}
            continue
        opt = get_optimizer("sgd", 0.1)
        state = steps.TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
        steps.make_train_step(model, opt)(state, {"tokens": tokens})
        assert fused_calls == {"causal_conv_silu": 0, "gated_rmsnorm": 0}
