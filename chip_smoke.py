#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain versions.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. device  - require CUDA; print the card's name and power limit; TF32 off.
  2. build   - build the hand-written CUDA kernels from csrc/ (sm_90a).
  3. kernels - each kernel vs its plain PyTorch version in bf16: the DiT's
               (5, 1024, 32, 128) with RMS-normed q/k, the VAE's D=512 at its
               encode and decode shapes, a ragged length with Lk != Lq, and
               inputs whose headroom forces the online branch.
  4. flagship attention (1, 28160, 32, 128): kernel time beside
               F.scaled_dot_product_attention (a yardstick the port never
               calls); output checked against the plain version on 2 heads.
  5. main path - load_pipeline() at the full 7B DiT and CV8x8x8 VAE in bf16,
               then inverse_render() of a seeded 512x512 image (5 passes
               batched, 15 steps, guidance 0); checks the outputs and that
               every attention call of the path launched the kernels.
  6. reference - the same DiT forward and VAE encode with the plain
               attention path, held against the kernel path.
  7. profile - torch.profiler over one DiT forward at the main path's shape.
  8. timings - each kernel, its plain version and the library call at the
               main path's attention shapes.
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

DIT_SHAPE = (5, 1024, 1024, 32, 128)     # 5 passes x one 512x512 frame
VAE_ENC_SHAPE = (1, 4096, 4096, 1, 512)  # mid-block spatial attention, encode
VAE_DEC_SHAPE = (5, 4096, 4096, 1, 512)  # and decode of the 5 pass rows
FLAGSHIP_SHAPE = (1, 28160, 28160, 32, 128)
# Kernel vs plain, both in bf16: max |err| within 2e-2 of max |plain| (the
# compared output's own scale, no floor) and a relative L2 error within 1e-2.
# Matching rounding points leave about one bf16 ulp (2^-8 relative) on a few
# elements; a dropped key tile or a wrong softmax scale moves the outputs by
# several percent of their size.
MAX_TOL = 2e-2
L2_TOL = 1e-2


class SmokeFailure(RuntimeError):
    pass


def compare(got, want):
    """(max |got - want|, relative L2 error, whether both are within limits)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    ok = (math.isfinite(err) and math.isfinite(rel)
          and err <= MAX_TOL * want.abs().max().item() and rel <= L2_TOL)
    return err, rel, ok


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*args) -> None:
    print(*args, flush=True)


def phase(name: str):
    say(f"== {name}")
    return time.perf_counter()


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def attention_bound(shape, noshift: bool):
    """(bound_ms, bound_by) of one attention call: q, k, v read and the
    output written once, against 4*B*Lq*Lk*H*D bf16 tensor-core operations
    and the fp32 softmax work per score (exp2 and the row sum; the online
    branch adds the max and the shift)."""
    b, lq, lk, h, d = shape
    nbytes = (2 * lq + 2 * lk) * b * h * d * 2
    scores = b * lq * lk * h
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(4 * scores * d / PEAK_BF16_FLOPS, (2 if noshift else 4) * scores / PEAK_FP32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def headroom_bound(shape):
    """q, k, v read once; ~3 fp32 operations per element (scale, square, add)."""
    b, lq, lk, h, d = shape
    elems = (lq + 2 * lk) * b * h * d
    t_bytes = elems * 2 / PEAK_BYTES
    t_ops = 3 * elems / PEAK_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def make_qkv(shape, *, rms_normed: bool, q_scale: float = 1.0, seed: int = 0):
    """bf16 (B, L, H, D) inputs on the card.  rms_normed mimics the DiT: q
    and k have unit RMS per head, as after its q/k RMSNorm."""
    import torch

    b, lq, lk, h, d = shape
    g = torch.Generator("cuda").manual_seed(seed)
    q = torch.randn(b, lq, h, d, generator=g, device="cuda")
    k = torch.randn(b, lk, h, d, generator=g, device="cuda")
    v = torch.randn(b, lk, h, d, generator=g, device="cuda")
    if rms_normed:
        q = q * torch.rsqrt(q.square().mean(-1, keepdim=True) + 1e-6)
        k = k * torch.rsqrt(k.square().mean(-1, keepdim=True) + 1e-6)
    return (q * q_scale).bfloat16(), k.bfloat16(), v.bfloat16()


def sdpa_ms(q, k, v, reps: int) -> float:
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def device_phase():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(smi.splitlines()[0])
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def build_phase():
    from diffusionrenderer_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.library()
    say(f"built {cuda_build.SOURCE.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_build.build_seconds:.1f} s)")
    for line in cuda_build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")


def kernel_case(name, shape, *, rms_normed, q_scale, expect_branch, seed):
    """Kernel vs plain on one input; returns max |kernel - plain|."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    q, k, v = make_qkv(shape, rms_normed=rms_normed, q_scale=q_scale, seed=seed)
    fa.reset_counts()
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    branches = fa.branch_counts("cuda")
    launches = dict(fa.LAUNCHES)
    want = fa.flash_attention_plain(q, k, v)
    err, rel, ok = compare(got, want)
    stats_err = (fa.flash_headroom(q, k, v) - fa.headroom_stats_plain(q, k, v)).abs().max().item()
    say(f"  {name} {shape}: max_abs_err {err:.3e} (tol {MAX_TOL * want.float().abs().max():.3e}), "
        f"rel_l2 {rel:.3e} (tol {L2_TOL:.0e}), headroom stats err {stats_err:.3e}, "
        f"launches {launches}, branches {branches}")
    check(ok, f"{name}: kernel disagrees with plain")
    check(stats_err <= 1e-4 * max(1.0, float(fa.headroom_stats_plain(q, k, v).abs().max())),
          f"{name}: headroom stats disagree with plain")
    check(launches == {"flash_attention": 1, "flash_attention_headroom": 1},
          f"{name}: launch counters did not rise by one")
    check(branches[expect_branch] == 1, f"{name}: expected the {expect_branch} branch")
    return err, stats_err


def kernels_phase():
    errs = [
        kernel_case("dit", DIT_SHAPE, rms_normed=True, q_scale=1.0,
                    expect_branch="noshift", seed=1),
        kernel_case("vae_d512", VAE_ENC_SHAPE, rms_normed=False, q_scale=1.0,
                    expect_branch="noshift", seed=2),
        kernel_case("vae_decode_d512", VAE_DEC_SHAPE, rms_normed=False, q_scale=1.0,
                    expect_branch="noshift", seed=6),
        kernel_case("ragged", (2, 1000, 777, 8, 128), rms_normed=True, q_scale=1.0,
                    expect_branch="noshift", seed=3),
        kernel_case("online", (2, 1000, 1000, 8, 128), rms_normed=False, q_scale=100.0,
                    expect_branch="online", seed=4),
        kernel_case("online_d512", (1, 1000, 1200, 1, 512), rms_normed=False, q_scale=100.0,
                    expect_branch="online", seed=5),
    ]
    return max(e for e, _ in errs), max(s for _, s in errs)


def flagship_phase():
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    q, k, v = make_qkv(FLAGSHIP_SHAPE, rms_normed=True, seed=7)
    fa.reset_counts()
    stats = fa.flash_headroom(q, k, v)
    kernel = time_ms(lambda: fa.flash_attention_kernel(q, k, v, stats), reps=5, warmup=1)
    online = time_ms(lambda: fa.flash_attention_kernel(q, k, v, None), reps=5, warmup=1)
    headroom = time_ms(lambda: fa.flash_headroom(q, k, v), reps=5, warmup=1)
    library = sdpa_ms(q, k, v, reps=5)
    out = fa.flash_attention(q, k, v)
    q2, k2, v2 = (x[:, :, :2].contiguous() for x in (q, k, v))
    plain2 = time_ms(lambda: fa.flash_attention_plain(q2, k2, v2), reps=1, warmup=0)
    online_plain2 = time_ms(lambda: fa.flash_attention_plain(q2, k2, v2, bounded=False),
                            reps=1, warmup=0)
    want = fa.flash_attention_plain(q2, k2, v2)
    err, rel, ok = compare(out[:, :, :2], want)
    torch.cuda.synchronize()
    bound, by = attention_bound(FLAGSHIP_SHAPE, noshift=True)
    b, lq, lk, h, d = FLAGSHIP_SHAPE
    rec = {"shape": list(FLAGSHIP_SHAPE), "ms": kernel, "online_ms": online,
           "online_bound_ms": attention_bound(FLAGSHIP_SHAPE, noshift=False)[0],
           "headroom_ms": headroom,
           "library_ms": library, "plain_ms_2_heads": plain2,
           "online_plain_ms_2_heads": online_plain2, "bound_ms": bound,
           "bound_by": by, "tflops": 4 * b * lq * lk * h * d / kernel / 1e9,
           "max_abs_err_2_heads": err, "rel_l2_2_heads": rel,
           "branches": fa.branch_counts("cuda")}
    say("flagship_attention " + json.dumps(rec))
    check(ok, "flagship: kernel disagrees with plain on 2 heads")
    del q, k, v, out, q2, k2, v2, want
    torch.cuda.empty_cache()
    return rec


def main_path_phase():
    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch.api import INVERSE_PASSES, inverse_render, load_pipeline
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = load_pipeline()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = get_inverse_renderer_config(512, 512, 1)  # what load_pipeline() builds
    net, vae = cfg.net, cfg.vae
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    say(f"  load_pipeline: {load_s:.2f} s, weights {weights_gib:.2f} GiB on the card "
        f"({net.model_channels} wide, {net.num_heads} heads, {net.num_blocks} blocks; "
        f"VAE {vae.encoder_block_out_channels})")
    image = np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)

    # The count the config implies: one attention call per DiT block per step
    # (guidance 0: one forward per step), plus the VAE mid-block's spatial
    # attention in the one batched encode and the one decode.
    expected = pipe.num_steps * net.num_blocks + 2
    fa.reset_counts()
    t0 = time.perf_counter()
    out = inverse_render(pipe, image)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    branches = fa.branch_counts("cuda")
    peak = torch.cuda.max_memory_allocated()
    timings = dict(pipe.timings)
    rec = {"wall_s": wall, "encode_s": timings["encode"], "denoise_s": timings["denoise"],
           "denoise_step_s": timings["denoise"] / pipe.num_steps,
           "decode_s": timings["decode"], "load_s": load_s,
           "peak_mem_gib": peak / 2 ** 30, "weights_gib": weights_gib,
           "launches": launches, "expected_launches": expected, "branches": branches}
    say("main_path " + json.dumps(rec))
    check(sorted(out) == sorted(INVERSE_PASSES), f"passes {sorted(out)}")
    for name, arr in out.items():
        check(arr.shape == (1, 512, 512, 3), f"{name} shape {arr.shape}")
        check(bool(np.isfinite(arr).all()) and arr.min() >= 0.0 and arr.max() <= 1.0,
              f"{name}: values not finite in [0, 1]")
    for name in ("flash_attention", "flash_attention_headroom"):
        check(launches[name] == expected, f"{name}: {launches[name]} launches, expected {expected}")
    check(branches["noshift"] + branches["online"] == expected, "branch counts do not add up")

    # The run above is the first on a fresh process (cuDNN / cuBLAS set-up
    # included); time the same call once more, warm.  Not counted.
    t0 = time.perf_counter()
    inverse_render(pipe, image)
    torch.cuda.synchronize()
    warm = {"wall_s": time.perf_counter() - t0, **{f"{k}_s": v for k, v in pipe.timings.items()},
            "denoise_step_s": pipe.timings["denoise"] / pipe.num_steps}
    say("main_path_warm " + json.dumps(warm))
    rec["warm"] = warm
    return pipe, rec


def reference_phase(pipe):
    """The main path's DiT forward and VAE encode with the kernels vs with
    the plain attention path, on the loaded full-size weights."""
    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.models.vae import vae_encode

    cfg = get_inverse_renderer_config(512, 512, 1)
    g = torch.Generator("cuda").manual_seed(3)
    x = torch.randn(5, 1, 64, 64, 16, generator=g, device="cuda").bfloat16()
    cond = torch.randn(5, 1, 64, 64, 16, generator=g, device="cuda").bfloat16()
    sigma = torch.full((5,), 2.5, device="cuda")
    ctx = torch.arange(5, device="cuda")
    res = {}
    with torch.no_grad():
        got = dit_forward(pipe.dit_params, x, sigma, cond, ctx, cfg.net).float()
        want = dit_forward(pipe.dit_params, x, sigma, cond, ctx, cfg.net,
                           attn_backend="xla").float()
        res["dit_rel_err"] = ((got - want).norm() / want.norm()).item()
        img = torch.rand(1, 1, 512, 512, 3, generator=g, device="cuda").mul(2).sub(1).bfloat16()
        got = vae_encode(pipe.vae_params, img, cfg.vae).float()
        want = vae_encode(pipe.vae_params, img, cfg.vae, attn_backend="xla").float()
        res["vae_encode_rel_err"] = ((got - want).norm() / want.norm()).item()
    say("reference " + json.dumps(res))
    # bf16 end to end through 28 blocks: a relative L2 error of a few 1e-3
    # is bf16 noise; 3e-2 would mean a wrong kernel.
    check(res["dit_rel_err"] < 3e-2, "DiT forward: kernel path disagrees with plain")
    check(res["vae_encode_rel_err"] < 3e-2, "VAE encode: kernel path disagrees with plain")
    return res


def profile_phase(pipe):
    """torch.profiler over one DiT forward at the main path's shape: device
    time by kernel class, and the device's idle share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward

    net = get_inverse_renderer_config(512, 512, 1).net
    g = torch.Generator("cuda").manual_seed(5)
    x = torch.randn(5, 1, 64, 64, 16, generator=g, device="cuda").bfloat16()
    cond = torch.randn(5, 1, 64, 64, 16, generator=g, device="cuda").bfloat16()
    sigma, ctx = torch.full((5,), 2.5, device="cuda"), torch.arange(5, device="cuda")

    def step():
        with torch.no_grad():
            dit_forward(pipe.dit_params, x, sigma, cond, ctx, net)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, copies, memsets); the CPU-side
    # aten:: events would count their kernels' time a second time.
    classes = {"gemm": 0.0, "flash_attention": 0.0, "headroom": 0.0, "elementwise/other": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Command Buffer"):
            continue
        dev_us = (ev.self_device_time_total if hasattr(ev, "self_device_time_total")
                  else ev.self_cuda_time_total)
        dev_ms = dev_us / 1e3
        name, low = ev.key, ev.key.lower()
        if "flash_attention_kernel" in name:
            cls = "flash_attention"
        elif "headroom_kernel" in name:
            cls = "headroom"
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "elementwise/other"
        classes[cls] += dev_ms
        top.append((dev_ms, ev.count, name[:80]))
    busy = sum(classes.values())
    top.sort(reverse=True)
    # Dense matmul work of the forward over its 5 x 32 x 32 tokens: per block
    # q, k, v, o (4 d^2) and the MLP (2 d * hidden) per token; the one-token
    # cross-attention and the AdaLN products are per row, not per token.
    tokens = x.shape[0] * (x.shape[2] // net.patch_spatial) * (x.shape[3] // net.patch_spatial)
    d = net.model_channels
    out_dim = net.patch_spatial ** 2 * net.patch_temporal * net.out_channels
    per_token = net.num_blocks * (4 * d * d + 2 * d * net.hidden_dim) + (net.patch_dim + out_dim) * d
    dense_tflop = 2 * tokens * per_token / 1e12
    rec = {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
           "by_class_ms": classes, "dense_matmul_tflop": dense_tflop,
           "gemm_tflops": dense_tflop / (classes["gemm"] / 1e3) if classes["gemm"] else None,
           "top": [[round(t, 3), c, n] for t, c, n in top[:12]]}
    say("profile_dit_forward " + json.dumps(rec))
    return rec


def kernel_records(main_rec, max_err, max_stats_err):
    """Per-kernel numbers at the main path's attention shapes."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    attn_shapes, head_shapes = [], []
    for shape, normed in ((DIT_SHAPE, True), (VAE_ENC_SHAPE, False), (VAE_DEC_SHAPE, False)):
        q, k, v = make_qkv(shape, rms_normed=normed, seed=11)
        stats = fa.flash_headroom(q, k, v)
        noshift = bool(fa.use_noshift(stats, shape[0] * shape[3], shape[2], shape[4]))
        reps = 20 if shape is DIT_SHAPE else 5
        bound, by = attention_bound(shape, noshift)
        attn_shapes.append({
            "shape": list(shape), "branch": "noshift" if noshift else "online",
            "ms": time_ms(lambda: fa.flash_attention_kernel(q, k, v, stats), reps),
            "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v), 2, warmup=1),
            "library_ms": sdpa_ms(q, k, v, reps), "bound_ms": bound, "bound_by": by,
            # The online branch on the same inputs (stats=None forces it).
            "online_ms": time_ms(lambda: fa.flash_attention_kernel(q, k, v, None), reps),
            "online_plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, bounded=False),
                                       2, warmup=1),
            "online_bound_ms": attention_bound(shape, noshift=False)[0]})
        hbound, hby = headroom_bound(shape)
        head_shapes.append({
            "shape": list(shape),
            "ms": time_ms(lambda: fa.flash_headroom(q, k, v), reps),
            "plain_ms": time_ms(lambda: fa.headroom_stats_plain(q, k, v), 2, warmup=1),
            "library_ms": None, "bound_ms": hbound, "bound_by": hby})
        del q, k, v, stats
        torch.cuda.empty_cache()
    src = "diffusionrenderer_tpu_torch/csrc/flash_attention.cu"
    main = main_rec["launches"]
    return [
        {"name": "flash_attention", "route": "cuda", "source": src,
         "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:185 (_flash_kernel_noshift) "
                     "and :58 (_flash_kernel)",
         "launches": main["flash_attention"], "launches_by_branch": main_rec["branches"],
         "max_abs_err": max_err, **attn_shapes[0], "main_path_shapes": attn_shapes},
        {"name": "flash_attention_headroom", "route": "cuda", "source": src,
         "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:488 (the headroom rule "
                     "_bounded_cond_call evaluates before its lax.cond; bound at :559)",
         "launches": main["flash_attention_headroom"], "max_abs_err": max_stats_err,
         **head_shapes[0], "main_path_shapes": head_shapes},
    ]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "diffusionrenderer_tpu_torch")):
        print("chip_smoke.py runs from the root of a checkout: the package "
              "diffusionrenderer_tpu_torch is not beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: chip_smoke.py needs a CUDA card",
              file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    t = phase("1 device")
    device_phase()
    t = phase("2 build")
    build_phase()
    t = phase("3 kernels vs plain")
    max_err, max_stats_err = kernels_phase()
    say(f"  phase 3: {time.perf_counter() - t:.1f} s")
    t = phase("4 flagship attention")
    flagship_phase()
    say(f"  phase 4: {time.perf_counter() - t:.1f} s")
    t = phase("5 main path: load_pipeline + inverse_render")
    pipe, main_rec = main_path_phase()
    say(f"  phase 5: {time.perf_counter() - t:.1f} s")
    t = phase("6 reference: kernel path vs plain attention path")
    reference_phase(pipe)
    say(f"  phase 6: {time.perf_counter() - t:.1f} s")
    t = phase("7 profile of one DiT forward at the main path's shape")
    profile_phase(pipe)
    del pipe
    torch.cuda.empty_cache()
    say(f"  phase 7: {time.perf_counter() - t:.1f} s")
    t = phase("8 kernel timings at the main path's shapes")
    records = kernel_records(main_rec, max_err, max_stats_err)
    say(f"  phase 8: {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
