"""Closed-loop render jobs through the program's API, one client: back to
back `api.inverse_render` (model_type 'inverse') or `api.forward_render`
('forward') calls, each on a fresh input and noise seed drawn from the run's
seed.

Traffic keys: model_type, frames, height, width, steps, guidance, passes
(inverse), env_format / env_rotation / env_flip / env_brightness /
panorama (forward), decode_chunk_frames, warmup_jobs, max_jobs (the pool
of inputs made in set-up), trace_jobs (the jobs a traced window holds),
check_jobs (the jobs the reference recomputes, drawn from the seed).

Set-up draws the weights, builds the pipeline, makes the input pool and
runs the warm-up jobs (the graph captures).  The window then runs jobs
until --seconds have passed; the record keeps each job's wall time, the
program's phase seconds and launch counts, and its output.  After the
window the program's graphs are released and the reference recomputes the
sampled jobs; the check holds the statistics of harness/compare.py that the
cell's limits file names, each the worst frame's, to their limits.

The control (ctx.control 'w8a8') is the program's own W8A8 path (int8
weights, per-token int8 activations), one step below the configuration's
bf16: the same run with that path switched on."""

from __future__ import annotations

import gc
import math
import random
import time
import traceback
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import compare, inputs, trace, weights
from perfbench.harness.context import Context, Record
from perfbench.reference import render as ref_render

MAX_FAILURES = 3


def _configs(cfg: Dict):
    from diffusionrenderer_tpu_torch.config import DiTConfig, VAEConfig

    net = DiTConfig(**cfg["net"])
    vae = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in cfg["vae"].items()})
    return net, vae


def _job_inputs(ctx: Context, tag, index) -> Dict:
    tr, dev = ctx.traffic, ctx.device
    t, h, w = tr["frames"], tr["height"], tr["width"]
    inp = {"noise_seed": inputs.derive(ctx.seed, tag, index, "noise")}
    if tr["model_type"] == "inverse":
        inp["rgb"] = inputs.rgb_video(inputs.derive(ctx.seed, tag, index, "rgb"), t, h, w, dev)
    else:
        inp["gbuffers"] = inputs.gbuffers(inputs.derive(ctx.seed, tag, index, "gbuffers"),
                                          t, h, w, dev)
        ph, pw = tr["panorama"]
        inp["panorama"] = inputs.hdr_panorama(inputs.derive(ctx.seed, tag, index, "env"),
                                              ph, pw, dev)
    return inp


def _caller(ctx: Context, pipe):
    from diffusionrenderer_tpu_torch import api

    tr = ctx.traffic
    if tr["model_type"] == "inverse":
        passes = tuple(tr["passes"])

        def call(inp):
            out = api.inverse_render(pipe, inp["rgb"], guidance=tr["guidance"],
                                     seed=inp["noise_seed"], passes=passes)
            return {p: out[p] for p in passes}
    else:
        def call(inp):
            g = inp["gbuffers"]
            out = api.forward_render(pipe, g["depth"], g["normal"], g["roughness"],
                                     g["metallic"], g["basecolor"], inp["panorama"],
                                     guidance=tr["guidance"], seed=inp["noise_seed"],
                                     env_format=tr["env_format"],
                                     env_brightness=tr["env_brightness"],
                                     env_flip_horizontal=tr["env_flip"],
                                     env_rotation=tr["env_rotation"])
            return {"rgb": out}
    return call


def _units(ctx: Context) -> int:
    """Output frames of one job: each pass's frames (inverse) or the relit
    frames (forward)."""
    tr = ctx.traffic
    per_pass = tr["frames"]
    return per_pass * (len(tr["passes"]) if tr["model_type"] == "inverse" else 1)


def _shape(ctx: Context) -> Dict:
    tr, vae = ctx.traffic, ctx.config["vae"]
    s = int(vae["spatial_compression_ratio"])
    t_lat = 1 if tr["frames"] == 1 else (tr["frames"] - 1) // int(
        vae["temporal_compression_ratio"]) + 1
    inverse = tr["model_type"] == "inverse"
    return {"rows": len(tr["passes"]) if inverse else 1,
            "latent_thw": (t_lat, tr["height"] // s, tr["width"] // s),
            "steps": int(tr["steps"]), "encodes": 1 if inverse else 8,
            "cfg_rows": 2 if tr["guidance"] > 0 else 1,
            "decoded_whole": not tr.get("decode_chunk_frames")}


def _counters():
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    return dict(fa.LAUNCHES)


def _generate_seconds(model_type: str) -> float:
    from diffusionrenderer_tpu_torch.utils.profiling import metrics

    entry = metrics.summary().get(f"generate/{model_type}")
    return entry["total_s"] if entry else 0.0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _as_u8(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {k: np.rint(np.asarray(v, np.float32) * 255.0).astype(np.uint8)
            for k, v in out.items()}


def build_pipeline(ctx: Context, w: Dict):
    from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline

    if ctx.control not in (None, "w8a8"):
        raise ValueError(f"a render has no control {ctx.control!r}")
    net, vae = _configs(ctx.config)
    dit = w["dit"]
    if ctx.control == "w8a8":
        from diffusionrenderer_tpu_torch.models.quant import quantize_dit_params

        dit = quantize_dit_params(dit, act_quant=True)
    pipe = DiffusionRendererPipeline(dit, w["vae"], model_type=ctx.traffic["model_type"],
                                     num_steps=int(ctx.traffic["steps"]),
                                     net_config=net, vae_config=vae)
    pipe.decode_chunk_frames = ctx.traffic.get("decode_chunk_frames")
    generate = pipe.generate

    def spanned_generate(*a, **k):
        with trace.span("generate"):
            return generate(*a, **k)

    pipe.generate = spanned_generate
    return pipe


def reference_outputs(ctx: Context, w: Dict, inp: Dict) -> Dict[str, np.ndarray]:
    tr, dev = ctx.traffic, ctx.device
    if tr["guidance"] != 0:
        raise ValueError("the reference renders guidance 0 only")
    if tr["model_type"] == "inverse":
        rgb = torch.from_numpy(inp["rgb"]).to(dev)
        return ref_render.inverse_job(w, ctx.config, rgb, tr["passes"], inp["noise_seed"],
                                      int(tr["steps"]))
    g = {k: torch.from_numpy(v).to(dev) for k, v in inp["gbuffers"].items()}
    env = {"rotation": float(tr["env_rotation"]), "flip": bool(tr["env_flip"]),
           "brightness": float(tr["env_brightness"]), "cube_res": int(tr["cube_res"])}
    if tr["env_format"] != "proj":
        raise ValueError("the reference projects env_format 'proj' only")
    out = ref_render.forward_job(w, ctx.config, g, torch.from_numpy(inp["panorama"]).to(dev),
                                 env, inp["noise_seed"], int(tr["steps"]))
    return {"rgb": out}


def run(ctx: Context) -> Record:
    tr, dev = ctx.traffic, ctx.device
    dtype = getattr(torch, ctx.config["dtype"])
    w = weights.draw(ctx.config, inputs.derive(ctx.seed, "weights"), dev, dtype)
    pipe = build_pipeline(ctx, w)
    call = _caller(ctx, pipe)
    pool = [_job_inputs(ctx, "job", k) for k in range(int(tr["max_jobs"]))]
    for k in range(int(tr["warmup_jobs"])):
        call(_job_inputs(ctx, "warmup", k))
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    units = _units(ctx)
    jobs: List[Dict] = []
    outputs: List = []
    failed = 0
    limit_jobs = int(tr["trace_jobs"]) if ctx.trace else len(pool)
    with trace.traced(ctx.trace, lambda: _sync(dev)) as tr_rec:
        start = time.perf_counter()
        deadline = start + ctx.seconds
        while (time.perf_counter() < deadline and len(jobs) + failed < min(limit_jobs, len(pool))
               and failed < MAX_FAILURES):
            inp = pool[len(jobs) + failed]
            before, gen_before = _counters(), _generate_seconds(tr["model_type"])
            try:
                with trace.span("job"):
                    t0 = time.perf_counter()
                    out = call(inp)
                    t1 = time.perf_counter()
            except Exception:  # a failed job is counted and the loop goes on
                failed += 1
                ctx.log(traceback.format_exc())
                continue
            after = _counters()
            jobs.append({"t0": t0, "t1": t1, "units": units, "index": len(jobs) + failed,
                         "generate_s": _generate_seconds(tr["model_type"]) - gen_before,
                         "encode_s": pipe.timings.get("encode"),
                         "denoise_s": pipe.timings.get("denoise"),
                         "decode_s": pipe.timings.get("decode"),
                         "launches": {k: after[k] - before.get(k, 0) for k in after}})
            outputs.append(out)
    rec = Record(setup_s=setup_s, window_start=start, deadline=deadline, jobs=jobs,
                 shape=_shape(ctx), trace=tr_rec, attempted=len(jobs) + failed, failed=failed)
    if dev.type == "cuda":
        rec.peak_reserved = int(torch.cuda.max_memory_reserved(dev))
    ctx.log(f"perfbench: {len(jobs)} jobs, {failed} failed; job s "
            + " ".join(f"{j['t1'] - j['t0']:.4f}" for j in jobs))

    # The check: the program's state (the pipeline and its graphs) released,
    # the reference recomputes a sample of the jobs drawn from the seed.
    del pipe, call
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rng = random.Random(inputs.derive(ctx.seed, "check"))
    picks = sorted(rng.sample(range(len(jobs)), min(int(tr["check_jobs"]), len(jobs))))
    worst: Dict[str, float] = {}
    t_ref = time.perf_counter()
    for i in picks:
        got = compare.worst(_as_u8(outputs[i]), reference_outputs(ctx, w, pool[jobs[i]["index"]]))
        ctx.log(f"perfbench: job {i} " + " ".join(f"{k} {v:.6g}" for k, v in got.items()))
        worst = {k: max(worst.get(k, -math.inf), v) for k, v in got.items()}
    rec.notes["reference_s"] = time.perf_counter() - t_ref
    ctx.log(f"perfbench: reference took {rec.notes['reference_s']:.1f} s for {len(picks)} jobs")
    rec.notes["readings"] = {ctx.control or "sound": worst}
    if picks:
        rec.checks = [{"name": k, "value": worst[k], "limit": float(v)}
                      for k, v in ctx.limits.items()]
    return rec
