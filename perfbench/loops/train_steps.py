"""Back-to-back steps of the program's DiT train step
(`training.train.make_train_step` with its AdamW; on the card a replayed
CUDA graph), one step after another on fresh seeded batches; each step ends
on its loss fetched to the host, as a training loop that logs the loss does.

Traffic keys: batch, frames, height, width (the latents are the VAE's
shape for them), learning_rate, weight_decay, condition_drop_rate, p_mean,
p_std (the loss's ln-sigma distribution, as the configuration states it),
checked_steps (the first steps, run in set-up and followed by the
reference), max_steps (the batches made in set-up), trace_steps (the steps
a traced window holds).

Set-up draws the weights, builds the state and the step, and drives it
through the checked steps.  On the card the step's first call runs eagerly
and captures the graph, and every later call replays it, so the checked
steps hold both paths: each step's loss; the first step's gradient norm per
leaf (from the first moment after step 1); the second step's, the first
the replayed graph computes (from the first moments after steps 1 and 2);
and, after the last checked step, each leaf's change.  The window then
runs steps on the same object until --seconds have passed.  After the
window the program's state is released and the reference runs the checked
steps from the same weights, batches and draws, and step 2 again from the
program's parameters after step 1 (kept on the host), so that the replayed
step is held to the reference's step from the same state, apart from the
drift of step 1's update; the check holds the gaps of `gaps` that the
cell's limits file names to their limits.

The control (ctx.control 'fp8') is the reference with fp8 matmul operands
put in the program's place: its readings are judged instead of the
program's, which the record keeps beside them."""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from perfbench.harness import inputs, trace, weights
from perfbench.harness.context import Context, Record
from perfbench.reference import train as ref_train

# Leaves whose reference gradient is below this share of the median leaf's
# move by round-off alone under Adam: their change is not compared.
MOVED_SHARE = 1e-3


def _batches(ctx: Context, n: int) -> List[Dict]:
    tr, dev = ctx.traffic, ctx.device
    s = int(ctx.config["vae"]["spatial_compression_ratio"])
    t_lat = 1 if tr["frames"] == 1 else (tr["frames"] - 1) // int(
        ctx.config["vae"]["temporal_compression_ratio"]) + 1
    shape = (n * tr["batch"], t_lat, tr["height"] // s, tr["width"] // s,
             int(ctx.config["vae"]["latent_channels"]))
    gen = torch.Generator(dev).manual_seed(inputs.derive(ctx.seed, "batches"))
    sd = float(ctx.config["scheduler"]["sigma_data"])
    dtype = getattr(torch, ctx.config["dtype"])
    lat = (torch.randn(shape, generator=gen, device=dev) * sd).to(dtype)
    cond = (torch.randn(shape, generator=gen, device=dev) * sd).to(dtype)
    ctx_idx = torch.randint(0, 5, (n * tr["batch"],), generator=gen, device=dev)
    b = tr["batch"]
    return [{"latents": lat[i * b:(i + 1) * b], "latent_condition": cond[i * b:(i + 1) * b],
             "context_index": ctx_idx[i * b:(i + 1) * b]} for i in range(n)]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _loss_kw(ctx: Context) -> Dict:
    tr = ctx.traffic
    return {"lr": float(tr["learning_rate"]), "wd": float(tr["weight_decay"]),
            "sigma_data": float(ctx.config["scheduler"]["sigma_data"]),
            "p_mean": float(tr["p_mean"]), "p_std": float(tr["p_std"]),
            "drop_rate": float(tr["condition_drop_rate"])}


def _rebuild(tree, new_leaves):
    it = iter(new_leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)

    return walk(tree)


def reference_readings(ctx: Context, skeleton, p0_host, p1_host, batches, *,
                       matmul_fp8=False) -> Dict:
    """The reference's checked steps from the host copy of the initial
    weights ('losses', each step's gradient norms 'grads', the change norms
    'change', by leaf path), and step 2 alone from the program's parameters
    after step 1 with step 2's draws ('loss2', 'grad2'), the readings the
    program's own step 2 is held to.  With matmul_fp8 these are the
    control's, which stands in the program's place."""
    dev, net, kw = ctx.device, ctx.config["net"], _loss_kw(ctx)
    params = _rebuild(skeleton, [p.to(dev, copy=True) for p in p0_host])
    gen = torch.Generator(dev).manual_seed(inputs.derive(ctx.seed, "draws"))
    losses, grads = ref_train.run_steps(params, net, batches, gen, matmul_fp8=matmul_fp8, **kw)
    change = {path: float((leaf.float() - p0.to(dev).float()).norm())
              for (path, leaf), p0 in zip(ref_train.leaves(params), p0_host)}
    del params
    out = {"losses": losses, "grads": grads, "change": change}
    if len(batches) > 1:
        params = _rebuild(skeleton, [p.to(dev, copy=True) for p in p1_host])
        gen = torch.Generator(dev).manual_seed(inputs.derive(ctx.seed, "draws"))
        ref_train.draws(gen, batches[0]["latents"])  # step 1's, as the program drew them
        loss2, grad2 = ref_train.run_steps(params, net, batches[1:2], gen,
                                           matmul_fp8=matmul_fp8, **kw)
        out.update(loss2=loss2[0], grad2=grad2[0])
        del params
    gc.collect()
    return out


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Worst relative gaps between the program's readings (or the
    control's) and the reference's: each loss against the reference's; each
    leaf's norm against the reference's norm of that leaf or of the median
    leaf, whichever is larger, over the leaves the reference's gradient of
    that step moves (at least MOVED_SHARE of the median leaf's gradient
    norm; the change over those of step 1).  grad_norm_gap is step 1's
    gradient; grad2_norm_gap and loss2_rel_gap step 2's (on the card the
    first the replayed graph computes), against the reference's step 2 from
    the same parameters after step 1.  Also the median leaf's gaps, and (as
    names) the worst leaves."""
    def leaf_gaps(p, r, moved_by):
        med_r = sorted(r.values())[len(r) // 2]
        med_g = sorted(moved_by.values())[len(moved_by) // 2]
        return {k: abs(p[k] - r[k]) / max(r[k], med_r) for k in moved_by
                if moved_by[k] >= MOVED_SHARE * med_g}

    pl, rl = prog["losses"], ref["losses"]
    out = {"loss_rel_gap": max(abs(a - b) / abs(b) for a, b in zip(pl, rl)),
           "first_loss_rel_gap": abs(pl[0] - rl[0]) / abs(rl[0])}
    readings = [("grad", prog["grads"][0], ref["grads"][0], ref["grads"][0]),
                ("update", prog["change"], ref["change"], ref["grads"][0])]
    if "grad2" in prog:
        out["loss2_rel_gap"] = abs(prog["loss2"] - ref["loss2"]) / abs(ref["loss2"])
        readings.insert(1, ("grad2", prog["grad2"], ref["grad2"], ref["grad2"]))
    for name, p, r, grad in readings:
        g = leaf_gaps(p, r, grad)
        out[f"{name}_norm_gap"] = max(g.values())
        out[f"{name}_norm_gap_median_leaf"] = sorted(g.values())[len(g) // 2]
        out[f"worst_{name}_leaf"] = max(g, key=g.get)
    return out


def _program(ctx: Context, w: Dict, batches: List[Dict], record_steps: int):
    """Build the step and drive it through the checked steps; returns
    (step, state, generator, host copies of the parameters before step 1
    and after it, program readings, bookkeeping seconds)."""
    from diffusionrenderer_tpu_torch.config import DiTConfig
    from diffusionrenderer_tpu_torch.training.train import (init_train_state, make_optimizer,
                                                            make_train_step)

    tr, dev = ctx.traffic, ctx.device
    params = w["dit"]
    named = ref_train.leaves(params)
    opt = make_optimizer(float(tr["learning_rate"]), float(tr["weight_decay"]))
    state = init_train_state(params, opt)
    step = make_train_step(DiTConfig(**ctx.config["net"]), opt,
                           sigma_data=float(ctx.config["scheduler"]["sigma_data"]),
                           condition_drop_rate=float(tr["condition_drop_rate"]))
    gen = torch.Generator(dev).manual_seed(inputs.derive(ctx.seed, "draws"))
    book = time.perf_counter()
    p0_host = [leaf.detach().to("cpu", copy=True) for _, leaf in named]
    book = time.perf_counter() - book
    losses: List[float] = []
    grad_norms: List[Dict[str, float]] = []
    p1_host, mu1_host = [], []
    for k in range(record_steps):
        state, loss = step(state, batches[k], gen)
        losses.append(float(loss.item()))
        t0 = time.perf_counter()
        mu = ref_train.leaves(state.opt_state.mu) if k < 2 else []
        if k == 0:
            # g1 = mu1 / (1 - B1); mu1 and the parameters kept on the host
            # for step 2's gradient and its reference.
            grad_norms.append({path: float(m.float().norm()) / (1 - ref_train.B1)
                               for path, m in mu})
            mu1_host = [m.detach().to("cpu", copy=True) for _, m in mu]
            p1_host = [leaf.detach().to("cpu", copy=True) for _, leaf in named]
        elif k == 1:
            # g2 = (mu2 - B1 mu1) / (1 - B1): the replayed step's gradient.
            grad_norms.append({path: float((m.float() - ref_train.B1 * m1.to(dev).float())
                                           .norm()) / (1 - ref_train.B1)
                               for (path, m), m1 in zip(mu, mu1_host)})
            mu1_host = []
        book += time.perf_counter() - t0
    t0 = time.perf_counter()
    change = {path: float((leaf.float() - p0.to(dev).float()).norm())
              for (path, leaf), p0 in zip(named, p0_host)}
    book += time.perf_counter() - t0
    prog = {"losses": losses, "grads": grad_norms, "change": change}
    if len(grad_norms) > 1:
        prog.update(loss2=losses[1], grad2=grad_norms[1])
    return step, state, gen, (p0_host, p1_host), prog, book


def run(ctx: Context) -> Record:
    if ctx.control not in (None, "fp8"):
        raise ValueError(f"the train step has no control {ctx.control!r}")
    tr, dev = ctx.traffic, ctx.device
    dtype = getattr(torch, ctx.config["dtype"])
    w = weights.draw(ctx.config, inputs.derive(ctx.seed, "weights"), dev, dtype, vae=False)
    skel = skeleton_shape(w["dit"])
    checked = int(tr["checked_steps"])
    batches = _batches(ctx, int(tr["max_steps"]))
    step, state, gen, host, prog, book = _program(ctx, w, batches, checked)
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start - book
    ctx.log(f"perfbench: set-up {setup_s:.3f} s after {book:.3f} s of the check's bookkeeping")

    steps: List[Dict] = []
    limit = checked + (int(tr["trace_steps"]) if ctx.trace else len(batches))
    with trace.traced(ctx.trace, lambda: _sync(dev)) as tr_rec:
        start = time.perf_counter()
        deadline = start + ctx.seconds
        k = checked
        while time.perf_counter() < deadline and k < min(limit, len(batches)):
            with trace.span("train_step"):
                t0 = time.perf_counter()
                state, loss = step(state, batches[k], gen)
                loss.item()
                t1 = time.perf_counter()
            steps.append({"t0": t0, "t1": t1, "units": 1})
            k += 1
    rec = Record(setup_s=setup_s, window_start=start, deadline=deadline, jobs=steps,
                 shape={"rows": tr["batch"], "latent_thw": tuple(batches[0]["latents"].shape[1:4]),
                        "steps": 1}, trace=tr_rec, attempted=len(steps))
    if dev.type == "cuda":
        rec.peak_reserved = int(torch.cuda.max_memory_reserved(dev))
    ctx.log(f"perfbench: {len(steps)} steps; step s "
            + " ".join(f"{s['t1'] - s['t0']:.4f}" for s in steps[:8]))

    del step, state, w
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(ctx, skel, *host, batches[:checked])
    rec.notes["readings"] = {"sound": gaps(prog, ref)}
    judged = rec.notes["readings"]["sound"]
    if ctx.control == "fp8":
        # In the program's place: the fp8 reference's steps from the start,
        # and its step 2 from the program's parameters after step 1.
        low = reference_readings(ctx, skel, *host, batches[:checked], matmul_fp8=True)
        judged = rec.notes["readings"]["fp8"] = gaps(low, ref)
    rec.notes["reference_s"] = time.perf_counter() - t_ref
    ctx.log(f"perfbench: losses {prog['losses']} reference {ref['losses']}; "
            + "; ".join(f"{mode}: " + " ".join(f"{k} {v}" for k, v in got.items())
                        for mode, got in rec.notes["readings"].items())
            + f"; reference {rec.notes['reference_s']:.1f} s")
    rec.checks = [{"name": k, "value": judged[k], "limit": float(v)}
                  for k, v in ctx.limits.items()]
    return rec


def skeleton_shape(tree):
    """The tree's structure with its leaves dropped (None), so that the
    program's tensors can be freed before the reference rebuilds it."""
    if isinstance(tree, dict):
        return {k: skeleton_shape(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [skeleton_shape(v) for v in tree]
    return None
