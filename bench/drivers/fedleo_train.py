"""Driver of traffic kind ``fedleo_train``: FedLEO orbit-replica training.

Set-up builds one training state (R replicas of the benchmark's float32
weights, Adam's state) and drives it through whole tau-cycles with the
window's own call and feed: ``make_fedleo_local_step`` on R fresh
batches of token ids drawn from the seed, ``make_fedleo_aggregate``
every tau local steps.  Its first ``checked_steps`` steps are read for
the check (losses, the first gradient from Adam's first moment, each
leaf's change).  The window then runs whole tau-cycles until one ends
after ``seconds``; with ``trace`` one more cycle runs under the
profiler.  Once the window has closed and the state is freed, the plain
reference follows the checked steps from the same weights and batches.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from bench import check, counts, harness, trace as tracing, weights
from bench.reference import model as ref_model
from bench.reference import train as ref_train

KEYS = frozenset({"replicas", "batch", "seq_len", "tau", "grad_clip", "samples", "checked_steps"})


def leaf_norms(tree: Dict, minus: Dict = None) -> List[Dict[str, float]]:
    """Per replica, the norm of each leaf of a stacked (R, ...) tree, or
    of its difference from the unstacked ``minus``."""
    items = list(ref_model.leaf_items(tree))
    base = dict(ref_model.leaf_items(minus)) if minus is not None else {}
    r_count = items[0][1].shape[0]
    out = []
    for r in range(r_count):
        norms = {}
        for name, x in items:
            d = x[r].float() - base[name].float() if minus is not None else x[r].float()
            norms[name] = float(torch.linalg.vector_norm(d))
        out.append(norms)
    return out


def _state_trees(state, r_count: int):
    """(K, N, itemsize) of each tree that the aggregation sends through K1:
    the parameters, then the optimizer state; a leaf counts when its
    leading axis holds the replicas, in the tree's promoted type."""
    from repro_torch.tree import tree_leaves

    out = []
    for tree in (state.params, state.opt_state):
        rep = [x for x in tree_leaves(tree) if x.ndim and x.shape[0] == r_count]
        if rep:
            dtype = rep[0].dtype
            for x in rep[1:]:
                dtype = torch.promote_types(dtype, x.dtype)
            if not dtype.is_floating_point:
                dtype = torch.float32
            itemsize = torch.empty((), dtype=dtype).element_size()
            out.append((r_count, sum(x[0].numel() for x in rep), itemsize))
    return out


def batches(cfg: dict, tf: dict, seed: int, device: torch.device):
    """The feed, without end: every local step R fresh (1, b, s) batches
    of token ids uniform over the vocabulary, drawn on the device from
    the seed."""
    gen = torch.Generator(device=device).manual_seed(weights.seed_for(seed, 1))
    shape = (tf["replicas"], 1, tf["batch"], tf["seq_len"])
    while True:
        yield {"tokens": torch.randint(0, cfg["vocab_size"], shape, generator=gen, device=device)}


class Setup:
    """The training state after set-up, with the pieces the window
    drives and what the checked steps read."""

    def __init__(self, cell: harness.Cell, seed: int, device: torch.device):
        from repro_torch.configs import build_model
        from repro_torch.optim import get_optimizer
        from repro_torch.train import fedleo_step, steps as program_steps

        cfg, tf = cell.config, cell.traffic
        tr = cfg["train"]
        r_count, tau = tf["replicas"], tf["tau"]
        self.tau, self.r_count, self.device = tau, r_count, device
        acfg = harness.program_config(cfg, remat=tr["remat"])
        self.model = build_model(acfg, attn_impl=tr["attn_impl"], ssd_impl=tr["ssd_impl"],
                                 dtype=getattr(torch, tr["compute_dtype"]), device=device)
        opt = get_optimizer(tr["optimizer"], tr["learning_rate"])
        params = weights.make(cfg, seed, getattr(torch, tr["param_dtype"]), device)
        self.state = fedleo_step.replicate_for_orbits(program_steps.TrainState(
            params, opt.init(params), torch.zeros((), dtype=torch.int32, device=device)), r_count)
        del params
        self.local_step = fedleo_step.make_fedleo_local_step(self.model, opt,
                                                             grad_clip=tf["grad_clip"])
        self.aggregate = fedleo_step.make_fedleo_aggregate(use_kernel=True)
        self.samples = torch.tensor(tf["samples"], dtype=torch.float32, device=device)
        self.feed = batches(cfg, tf, seed, device)

        # whole tau-cycles through the window's call and feed, the first
        # checked_steps of them read for the check
        checked = tf["checked_steps"]
        self.fed, self.prog = [], {"loss": []}
        for t in range(tau * math.ceil(checked / tau)):
            batch = next(self.feed)
            self.state, metrics = self.local_step(self.state, batch)
            if t < checked:
                self.fed.append(batch["tokens"][:, 0])
                self.prog["loss"].append([float(x) for x in metrics["loss"]])
            if t == 0:
                self.prog["grad_norm"] = [{k: v / (1.0 - tr["adam_b1"]) for k, v in r.items()}
                                          for r in leaf_norms(self.state.opt_state.mu)]
            if (t + 1) % tau == 0:
                self.state = self.aggregate(self.state, self.samples)
            if t == checked - 1:
                p0 = weights.make(cfg, seed, getattr(torch, tr["param_dtype"]), device)
                self.prog["change_norm"] = leaf_norms(self.state.params, p0)
                del p0
        harness.sync(device)

    def cycle(self, spans=None) -> List[torch.Tensor]:
        """One tau-cycle: tau local steps, then the aggregation; returns
        the steps' losses.  With ``spans``, each local step is timed on
        the host clock to a synchronise and the aggregation by CUDA
        events."""
        losses = []
        for _ in range(self.tau):
            batch = next(self.feed)
            w0 = time.perf_counter()
            self.state, metrics = self.local_step(self.state, batch)
            losses.append(metrics["loss"])
            if spans is not None:
                harness.sync(self.device)
                spans["local_step_s"].append(time.perf_counter() - w0)
        timed = spans is not None and self.device.type == "cuda"
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        self.state = self.aggregate(self.state, self.samples)
        if timed:
            ev[1].record()
            spans["aggregate_events"].append(ev)
        return losses


def reference(cell: harness.Cell, seed: int, fed, device: torch.device,
              prec=ref_model.exact) -> dict:
    """The plain reference's readings of the checked steps, from the
    seed's weights and the batches the program was fed."""
    p0 = weights.make(cell.config, seed, torch.float32, device)
    return ref_train.follow(dict(ref_model.leaf_items(p0)), fed, cell.config, cell.traffic,
                            cell.family.reference.blocks, prec)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float) -> dict:
    cfg, tf = cell.config, cell.traffic
    b, s = tf["batch"], tf["seq_len"]
    st = Setup(cell, seed, device)
    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    spans = {"local_step_s": [], "aggregate_events": []} if trace else None
    t_start = time.perf_counter()
    setup_s = t_start - t0
    steps, window_losses = 0, []
    while True:
        window_losses += st.cycle(spans)
        steps += st.tau
        harness.sync(device)
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if spans is not None:
        spans["aggregate_ms"] = [a.elapsed_time(e) for a, e in spans.pop("aggregate_events")]
    losses_w = torch.stack(window_losses).float()
    failed = int((~torch.isfinite(losses_w)).any(dim=1).sum())

    profile, launches = None, {}
    if trace and on_card:
        from repro_torch.kernels.aggregate import KERNEL, aggregate_flat

        def session():
            before = aggregate_flat.launches
            with tracing.device_profile() as prof:
                st.cycle()
            return tracing.read(prof), [((KERNEL,), aggregate_flat.launches - before)]

        profile = tracing.whole_profile(session)
        launches["aggregate"] = _state_trees(st.state, st.r_count)

    tokens = steps * st.r_count * b * s
    record = {
        "cell": cell.name, "config": cfg, "traffic": tf,
        "end_to_end": {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s},
        "window": {"seconds": window_s, "steps": steps, "tokens": tokens,
                   "flops": counts.train_step_flops(cfg, b, s) * st.r_count * steps},
        "spans": spans or {}, "launches": launches, "profile": profile,
        "memory": {"window_peak_bytes": window_peak},
        "attempted": steps, "failed": failed,
        "device": harness.device_info(device, max(setup_peak, window_peak)),
    }

    # the check, after the window, with the program's state freed
    prog, fed = st.prog, st.fed
    del st, window_losses, losses_w
    if on_card:
        torch.cuda.empty_cache()
    ref = reference(cell, seed, fed, device)
    record["numbers"] = check.train_numbers(prog, ref)
    record["readings"] = {"program": prog, "reference": ref, "fed": fed}
    return record
