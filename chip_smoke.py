#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels against
their plain versions.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero).  Every render on one
card without a mesh (phases 7, 10, 21, 24-29, 33, 34) denoises through the
replayed CUDA graph of one Euler step (pipeline._StepGraphs) and encodes
its conditions and decodes (unchunked) through replayed VAE graphs
(pipeline._VaeGraphs), its first call capturing them; the sharded renders
(16, 31) and the chunked decode (25) run eagerly.  The FADITV2_7B train
steps of phases 30(c) and 35 replay a captured step (make_train_step on the
card); the sharded and ring steps (30(f), 31) run eagerly.
  1. device  - require CUDA; print the card's name and power limit; TF32 off.
  2. build   - build every hand-written CUDA kernel from csrc/ (sm_90a), one
               nvcc per source, all started together, and beside them the
               HDR codec (csrc/*.cc, host compiler, zlib); print ptxas's
               registers and spills, and the registers, spills, dynamic shared
               memory and resident blocks per SM of the launch holding kernels
               1 and 2 and of kernels 3, 6 and 7 (D = 64, 128, 256, 512),
               kernel 5 (D = 128, 256, 512) and kernel 4 (per channel,
               grouped) from the CUDA runtime.  Fails on a spill or a
               serialized wgmma in the wgmma kernels, and if one of them keeps
               fewer than 8 warps per SM resident.
  3. kernels - the bf16 attention kernels vs their plain PyTorch version,
               each bounded call one headroom and one attention launch: both
               branches (kernel 1 no-shift, kernel 2 online) at D = 128 and 64
               at the DiT's (5, 1024, 32, 128) with RMS-normed q/k, the
               forward render's (1, 1024|2048, 32, 128), ragged lengths with
               Lk != Lq and fewer keys than one tile; the VAE's D=512 at its
               encode and decode shapes and ragged D = 512 and 256 lengths in
               both branches (the wide-head body); one no-shift case in fp32's
               underflow band; then kernel 2 alone (bounded=False) at the DiT and forward
               shapes, ragged lengths at D = 128 and 64 and fewer keys than
               one tile.
  4. flagship attention (1, 28160, 32, 128) and the flagship's VAE
               attention (8, 14080, 1, 512): kernel time beside
               F.scaled_dot_product_attention (a yardstick the port never
               calls); output checked against the plain version on 2 heads
               (the VAE shape: on its first batch row).
  5. W8A8 matmul kernel vs its plain version at the DiT's three block
               matmul shapes, per channel and g128, plus ragged M, g32 and
               g512, and the wgmma body's edges (a k32 step across K, partial
               tiles, M = 64, g256, fp32 output); timed beside torch._int_mm
               and bf16 F.linear, with each shape's share of its bound.
  6. int8 attention kernel vs its plain version (at the kernel's key tile)
               and vs attention_xla, qk8 and qk8+pv8, at the DiT shape and a
               ragged one; the flagship shape timed beside SDPA and the bf16
               kernel, compared on 2 heads.
  7. main path - load_pipeline() at the full 7B DiT and CV8x8x8 VAE in bf16,
               then inverse_render() of a seeded 512x512 image (5 passes
               batched, 15 steps, guidance 0); checks the outputs and that
               every attention call of the path made one headroom and one
               attention launch (422 each, with the branch tally); then a
               warm call (phases 33 and 34 time more, in turns with the
               eager paths).
  8. reference - the same DiT forward and VAE encode with the plain
               attention path, held against the kernel path.
  9. profile - torch.profiler over one DiT forward at the main path's shape.
  10. quantized main path - the same inverse_render() under
               load_pipeline(quantize_int8=True, act_quant=True) (w8a8) and
               with quant_group_size=128 (w8a8_g128): every block matmul
               launches the W8A8 kernel (6 x 28 x 15 per call); a warm
               call each (phases 33 and 34 time more).
  11. quantized reference - one W8A8 DiT forward through the kernels vs
               through the plain versions, and vs the bf16 forward.
  12. int8 attention path - one W8A8 DiT forward with
               attn_backend='pallas_pv_int8': 28 int8 attention launches.
  13. profile of one W8A8 and one W8A8-g128 DiT forward, and the
               activation pre-pass time.
  14. kernels 3, 6 and 7 vs their plain versions: the partial-stats kernel
               (out, m and l) and the two bounded-shift kernels at the DiT,
               forward and 9-frame shapes, D = 64, ragged lengths, fewer keys
               than one tile, the VAE's D=512 at its encode and decode shapes,
               D = 256 at (2, 1024, 8, 256) and ragged, and fp32's underflow
               band; kernel 6 bitwise against kernel 7 at every head dim (the
               wgmma bodies; at D = 256, 512 one schedule), each case's key
               split (kernels 3, 6 and 7 at D = 256, 512 where pairs of
               half-length blocks take fewer waves) as expected, and the
               unsplit launches against the plain version where they split,
               kernel 3 also split where two key tiles allow it; kernel 3's
               unsplit output bitwise against the unbounded call at every
               head dim (kernel 2's online body).
  15. ring merge on one card - the flagship shape's keys in 4 shards,
               kernel 3 on each, merged by the ring's _merge and normalized,
               against kernel 2's exact attention over all keys; the same at
               the VAE's decode shape (D = 512, the wide body).
  16. sharded main path - a one-rank NCCL group started here, then
               load_pipeline() + pipe.shard(make_mesh(1, data=1, seq=1,
               tensor=1), sp_attn='ring') + inverse_render(): every DiT
               attention call launches kernel 3 (28 x 15 per call); 5 warm
               calls (median and quartiles); one DiT
               forward on this path vs the unsharded kernel path, and one
               with sp_attn='flash_sp' (kernel 2 on the all-gathered KV)
               bitwise against the unsharded 'pallas_onlinemax' forward.
  17. bounded-shift DiT forwards - one DiT forward with
               flash_attention(bounded=True, pipelined=True) as its attention
               (kernel 6, 28 launches) and one with
               flash_attention_bounded_shift (kernel 7): bitwise equal to each
               other, and within bf16 noise of the kernel path's forward.
  18. timings of kernels 3, 6 and 7 at the DiT and flagship shapes and at
               the wide heads (the VAE's encode, decode and flagship shapes
               at D = 512, (2, 1024, 8, 256)), beside kernel 2, kernel 1's
               wide-head launch and their yardsticks (for kernel 3 the
               PyTorch call that returns the output with its log-sum-exp,
               where one takes the head dim); kernels 3, 6 and 7 also with
               the key split forced on and off.
  19. kernel 5 at head dims 512 and 256 (the VAE's (1|5, 4096, 1, 512), a
               ragged D=512 length, (2, 1024, 8, 256)), qk8 and qk8+pv8 (two
               warpgroups at D = 512): vs its plain version at the kernel's
               key tile and vs attention_xla;
               attention(backend='pallas_pv_int8') launches it; timed beside
               SDPA and kernel 1.
  20. envmap - a seeded 1024x2048 HDR panorama written with the port's .hdr
               codec and read back through load_hdr (RGBE precision); 8
               seeded 1024x2048 .hdr files through io.load_batch (the
               codec's thread pool, 4 threads) bitwise 8 serial native_read
               calls, both walls; the cubemap and direct projections and the
               ball tone map at 512x512 on the card against the same
               functions on the CPU.
  21. forward main path - load_pipeline(model_type='forward') at the full 7B
               width, then forward_render() of seeded uint8 G-buffers and the
               panorama at 512x512 (1 frame, 15 steps, guidance 0,
               env_format='proj'), first call, 5 warm calls (median and
               quartiles) and a 9-frame job: outputs, and one headroom and one
               attention launch per attention call (28 x 15 + 8 encodes + 1
               decode = 429) with the branch tally.
  22. forward reference - one forward DiT step through the kernels vs the
               plain attention path, and its profile.
  23. timings - each bf16 attention kernel (kernel 1's bounded call, kernel
               2's unbounded one, kernel 6 at D = 128), its plain version and
               the library call at the main path's attention shapes and the
               flagship shape, each with its ratio to the library, by CUDA
               events and again with every launch queued behind a sleep kernel
               (the device time alone, where the event time of a small shape
               reads the host's launch rate); the host cost of a bounded and
               an unbounded call (tensor maps encoded per call).
  24. checkpoints - the seeded full-width DiT (28 blocks, 4096 wide) written
               in bf16 as a reference-format .safetensors file (~13.7 GiB,
               under build/, removed at the end) and the CV8x8x8 VAE as a
               diffusers directory with the bundled latent statistics in its
               config.json; load_pipeline(dit_checkpoint=..., vae_checkpoint=...)
               bitwise equal to the in-memory weights with a device peak
               within the weights plus 1 GiB; the same files quantized on load
               (W8A8) bitwise equal to quantize_dit_params of the in-memory
               weights, and one W8A8 DiT forward from each bitwise equal (168
               kernel-4 launches); the W8A8 tree through save_native /
               restore_native bitwise.  Write, load and round-trip seconds.
  25. long video - from phase 24's pipeline, inverse_render(passes=
               ('basecolor',)) of a seeded uint8 (1, 57, 704, 1280, 3) clip
               (8 latent frames, 28,160 tokens) with decode_chunk_frames = 4:
               outputs finite in [0, 1], the first chunk's 25 frames bitwise
               an unchunked decode of latents 0-3 of the same sample, one
               headroom and one attention launch per DiT block and step plus
               one per encode and per decode chunk (424); phase seconds, ms
               per DiT step, and the decoder's peak chunked and unchunked;
               the pipeline's mlp_token_chunks as resolved (4 at 28,160
               tokens), the render's peak and ms per step beside those
               measured before the pipeline chunked the MLP,
               and one DiT forward at that shape with 4 MLP chunks against
               one with none (peaks, times, relative L2).
  26. guidance - one pass at 512x512, 1 frame, guidance 1.0 and 0.0, first
               call and 3 warm calls each (median ms per DiT step).
  27. the CLI - `python -m diffusionrenderer_tpu_torch.cli` in subprocesses
               on the card at full width (no --cpu, no --tiny): info;
               inverse --passes basecolor,normal of a seeded 512x512 PNG
               written by the port's codec, from phase 24's reference
               files (15 steps); forward of seeded PNG G-buffers under
               phase 20's .hdr; envmap.  Each subprocess's wall time, its
               generate/* registry times and kernel launches (422 / 429 /
               0); the PNGs read back through the port's codec.
  28. the ComfyUI nodes - LoadDiffusionRendererModel from phase 24's
               files in bf16 and in its default w8a8 (2,520 kernel-4
               launches), Cosmos1InverseRenderer on a CPU float IMAGE
               tensor, bitwise api.inverse_render on the same pipeline and
               seed; LoadHDRImage of phase 20's panorama into
               Cosmos1ForwardRenderer on a forward pipeline.  Phase 24's
               files are removed after this phase.
  29. the server - ServingExecutor(max_batch=5) over a bf16 inverse
               pipeline: five requests (context_index 0-4, seeds 0-4) from
               five threads as one dispatch of 5 rows (the registry's
               serving/dispatch count), each row bitwise a direct 5-row
               generate and within 30 dB PSNR of its solo generate; the
               latency (submit -> result), the dispatch beside the direct
               generate, 422 attention launches; then a trickle of 512x512
               and 256x256 requests and shutdown(drain=True) with requests
               pending, every future resolved.
  30. training - (a) FlashAttentionFunction at (1, 1024, 32, 128) bf16:
               kernel 3 forward + the plain backward vs autograd through
               attention_xla in fp32 (dq, dk, dv within 1e-2 relative L2),
               its forward + backward time beside SDPA's; (b) one train
               step's gradients of a 2-block DiT at the full width in bf16
               through the kernel vs the plain path in fp32, leaf by leaf,
               every leaf but the unused cross-attention q / k ones with a
               gradient; (c) the 28-block FADITV2_7B from load_pipeline's
               weights on VAE-encoded seeded 512x512 latents: 3 train steps
               at batch 1 and 2 at batch 2 with grad_accum=2 (condition
               dropout 0.1): losses finite, 28 kernel-3 launches per
               microbatch forward, every leaf with a gradient moved (the
               RMSNorm scales: a nonzero first moment); the step graphs
               then released, a sixth step, eager, under torch.profiler
               (device time by class, the attention backwards' and AdamW's
               share, idle share); step wall times and the peak (the steps
               replay their captured graph: phase 35 holds it to the eager
               step); (d) train_loop at 2 blocks, full
               width: 4 steps straight and 2 + resume + 2 bitwise equal, the
               save and restore seconds; on a one-rank NCCL mesh: (e) ring
               attention's gradient at (5, 1024, 32, 128) (RingAttentionFunction:
               one kernel-3 launch a forward, the plain backward ring) vs
               FlashAttentionFunction and vs fp32 autograd (dq, dk, dv
               within 1e-2 relative L2), its forward + backward time beside
               the Function's and SDPA's; (f) from (c)'s starting weights, 3
               FADITV2_7B steps through edm_loss(attn_backend='ring') on
               (c)'s latents and draws: 28 kernel-3 launches a step, each
               loss within 1% of (c)'s step, walls and the peak.
  31. several ranks on the one card - spawned interpreters (never forked)
               with a gloo process group each (NCCL takes one rank per card),
               after phase 2 has built the kernels; each rank joined with its
               own timeout, and a rank that fails or hangs fails the run.
               (a) which collectives gloo takes on bf16 and fp32 CUDA tensors
               (point-to-point crashes the ranks; the port calls none);
               (b) 4 ranks on make_mesh() = (1, 2, 2), JAX's default:
               load_pipeline() one rank at a time, shard(mesh) (the DiT's
               blocks halved per rank), inverse_render of phase 7's image
               in MULTI_RANK_RENDER_STEPS steps (140 kernel-2 launches on
               the all-gathered KV + the VAE's 2 bounded calls per rank),
               one DiT forward vs the unsharded
               kernel path (rel L2 <= 2e-2); then on 2 ranks: (c) W8A8 and
               W8A8-g128 forwards at tensor = 2 (168 kernel-4 launches per
               rank at the shard shapes) vs the unsharded W8A8 forward; (d)
               GPipe, 2 stages of 14 blocks, M = 5, vs the unsharded forward;
               (e) ring attention's gradient at (5, 1024, 32, 128) on (1, 2,
               1), 512 tokens a rank, 2 kernel-3 launches a rank, gathered vs
               the unsharded FlashAttentionFunction (rel L2 <= 1e-2); 4-block
               full-width train steps at tensor = 2, data = 2, GPipe S = 2,
               seq = 2 on the all-gathered KV and seq = 2 through ring
               attention (8 kernel-3 launches a rank), every leaf's gradient
               gathered whole vs the fp32 plain path (rel L2 <= 5e-2; where
               the unsharded bf16 path is itself past that, vs that path,
               or for the ring no further from fp32 than it by more than
               5e-2); and phase 32 (d) on the same two ranks.  Kernel 4 at
               the shard shapes and kernel 2 at the per-rank attention
               shapes timed on the card alone.  Times through gloo are
               host-staged.
  32. crossattn_emb at full width - the FADITV2_7B inverse DiT with
               load_pipeline()'s seeded weights at phase 7's shape (5 rows,
               1,024 tokens): (a) a (5, 1, 1024) context of the table's rows
               bitwise the context_index forward; (b) a seeded (5, 512, 1024)
               context (the general cross-attention: q / k RMSNorm, plain
               fp32-softmax attention over 512 keys) through the kernels vs
               the plain attention path (phase 8's bound), 28 launches each
               of the attention and headroom kernels, the forward's ms at 1
               and 512 context tokens and its profile; (c) the same under W8A8 per channel:
               280 kernel-4 launches a forward (168 with one token), vs its
               plain W8A8 version (phase 11's bound), kernel 4 at the
               context's (2560, 1024, 4096) per channel and g128 vs its plain
               version, timed beside torch._int_mm and its bound; (d) at
               tensor = 2 on phase 31's two gloo ranks, the cross-attention's
               q / k / v column-parallel and its out row-parallel, vs the
               unsharded forward (phase 31's bound).
  33. compiled denoise - five renders at full width, each on a fresh
               pipeline: inverse_render in bf16, w8a8 and w8a8_g128 (5
               passes), forward_render (1 frame) and one inverse pass at
               guidance 1.0, then reused at 2.0 (refilled, not captured
               again).  The replayed step graph against the eager loop
               (the _eager_denoise hook): outputs and final latents bitwise,
               launches (422 / 2,520 W8A8 / 429 / 422) and the branch tally
               equal; the capture's seconds, the graph's pool, each first
               call's peak; COMPILED_WARM warm calls of each in turns (median
               and quartiles, ms per step); one replayed and one eager step
               under torch.profiler (device time, idle share).
  34. compiled VAE - phase 33's five renders (and the guidance 2.0 reuse),
               each on a fresh pipeline, the encode and decode replayed (the
               default) against the eager VAE (the _eager_vae hook), the
               denoise replayed in both: outputs and final latents bitwise,
               launches (422 / 2,520 W8A8 / 429 / 422) and the branch tally
               equal; the encode and decode graphs' capture seconds and
               shared pool, the render's allocated and reserved peaks, and
               the warm encode and decode seconds of COMPILED_WARM calls each.
  35. compiled train step - phase 30(c)'s FADITV2_7B weights and latents,
               3 steps at batch 1 and 2 at batch 2 with grad_accum=2, twice
               from the same fresh state: eager (the step's _eager hook),
               then replayed (the default; each batch shape's first step
               eager, then captured).  Losses bitwise, every parameter and
               both moments bitwise by per-leaf digests, 28 kernel-3
               launches per microbatch; step walls, each shape's allocated
               and reserved peaks, capture seconds, the shared pool, and one
               replayed step under torch.profiler (device time, idle share).
  36. fused norm chains - csrc/dit_fused.cu's residual_ln_modulate at its
               three DiT call sites and qk_rmsnorm_rope, at the inverse and
               forward token counts (D = 4096, 32 heads of 128): each against
               its plain chain, its device ms (queued) beside its byte bound
               and the plain chain's ms, and the sums per DiT forward.
               `python3 chip_smoke.py 36` runs phases 1, 2 and 36 alone.
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense: bf16 and int8 tensor cores, fp32
# outside them, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

DIT_SHAPE = (5, 1024, 1024, 32, 128)     # 5 passes x one 512x512 frame
VAE_ENC_SHAPE = (1, 4096, 4096, 1, 512)  # mid-block spatial attention, encode
VAE_DEC_SHAPE = (5, 4096, 4096, 1, 512)  # and decode of the 5 pass rows
FLAGSHIP_SHAPE = (1, 28160, 28160, 32, 128)
# The flagship's VAE mid-block attention: 57 frames at 704x1280 are 8 latent
# frames of 88 x 160 tokens, one head of 512.
FLAGSHIP_VAE_SHAPE = (8, 14080, 14080, 1, 512)
# D = 256 at 8 heads, the wide head dim no model of the repo has.
D256_SHAPE = (2, 1024, 1024, 8, 256)
# The forward render's DiT attention: one 512x512 frame, and a 9-frame clip
# (2 latent frames); its VAE attention is VAE_ENC_SHAPE (8 encodes, 1 decode).
FWD_DIT_SHAPE = (1, 1024, 1024, 32, 128)
FWD9_DIT_SHAPE = (1, 2048, 2048, 32, 128)
# The DiT's block matmuls at the main path's 5 x 1024 tokens, (M, K, N):
# fa wq/wk/wv/wo, mlp w1, mlp w2.
QMM_SHAPES = ((5120, 4096, 4096), (5120, 4096, 16384), (5120, 16384, 4096))
QMM_PER_BLOCK = {(5120, 4096, 4096): 4, (5120, 4096, 16384): 1, (5120, 16384, 4096): 1}
# int8 attention vs attention_xla: the bounds of the JAX package's tests
# (tests/test_flash_attention.py), int8 QK^T and int8 QK^T + PV.  They were
# set on 65,536 outputs; on the DiT's 21M the same algorithm, run by its
# plain version at the JAX kernel's own key tiling, reaches past them (a
# maximum over more draws of the same quantization error), so there the
# limit is also met by staying within 10% of what that reference reaches.
INT8_XLA_TOL = {False: 0.012, True: 0.025}
PREPASS_RANGE = "w8a8_activation_prepass"
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


def queued_ms(fn, reps: int) -> float:
    """Mean device time of fn() by CUDA events with every launch enqueued
    before the first runs: a sleep kernel holds the device while the host
    enqueues, so the host's launch cost does not show."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7 + 4e5 * reps))  # ~10 ms + 0.2 ms a call at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_us(fn, calls: int = 200) -> float:
    """Host time per call of fn() enqueued back to back (no synchronize
    inside): the launch cost a host-bound caller pays."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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
    return smi.splitlines()[0]


# ptxas reports wgmma.mma_async serialized (the whole function's wgmma then
# run one at a time) with this phrase.
SERIALIZED = "wgmma.mma_async instructions are serialized"
WGMMA_SOURCES = ("flash_attention_wgmma", "flash_attention_int8", "quant_matmul")
# Resident warps per SM the wgmma kernels must keep: two warpgroups.
MIN_WGMMA_WARPS = 8


def build_phase():
    import threading

    from diffusionrenderer_tpu_torch import io as tio
    from diffusionrenderer_tpu_torch.ops import cuda_build
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm

    t0 = time.perf_counter()
    # The HDR codec (host C++ compiler, zlib) builds beside the nvcc jobs.
    codec_err, codec_s = [], []

    def build_codec():
        try:
            tio.codec()
        except (RuntimeError, OSError) as e:
            codec_err.append(str(e))
        codec_s.append(time.perf_counter() - t0)

    codec = threading.Thread(target=build_codec)
    codec.start()
    cuda_build.build_all()
    codec.join()
    check(not codec_err, f"the HDR codec did not build: {codec_err}")
    say(f"built {len(cuda_build.SOURCES)} sources in {time.perf_counter() - t0:.1f} s "
        f"(nvcc s: {json.dumps({k: round(v, 1) for k, v in cuda_build.build_seconds.items()})}; "
        f"HDR codec {codec_s[0]:.1f} s)")
    for name in cuda_build.SOURCES:
        log = cuda_build.build_log(name)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or SERIALIZED in line:
                say(f"  ptxas {name}: {line.strip()}")
        if name in WGMMA_SOURCES:
            check(SERIALIZED not in log, f"{name}.cu: ptxas serialized the wgmma instructions")
            spills = [m.group(0) for m in re.finditer(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
                      if m.group(1) != "0" or m.group(2) != "0"]
            check(not spills, f"{name}.cu: ptxas reports spills: {spills}")
    # The launch holding kernels 1 and 2, kernels 3, 6 and 7 (the wide-head
    # body at D = 256, 512), kernel 5 (two warpgroups at D = 512), kernel 4:
    # all on wgmma.
    occ = {}
    for d in (64, 128, 256, 512):
        occ[f"kernel12_attention_d{d}"] = fa.kernel_occupancy("attention", d)
        occ[f"kernel6_bounded_pipe_d{d}"] = fa.kernel_occupancy("bounded_pipe", d)
        occ[f"kernel7_bounded_d{d}"] = fa.kernel_occupancy("bounded", d)
        occ[f"kernel3_partial_d{d}"] = fa.kernel_occupancy("partial", d)
    occ["kernel4_w8a8_per_channel"] = qm.kernel_occupancy(False)
    occ["kernel4_w8a8_grouped"] = qm.kernel_occupancy(True)
    for d in (128, 256, 512):
        for pv8 in (False, True):
            occ[f"kernel5_d{d}_{'pv8' if pv8 else 'qk8'}"] = fa.kernel_occupancy("int8", d, pv8)
    say("occupancy " + json.dumps(occ))
    for name, o in occ.items():
        say(f"  {name}: {o['registers']} registers, {o['dynamic_smem_bytes']} B dynamic shared "
            f"memory, {o['blocks_per_sm']} blocks of {o['threads_per_block']} threads per SM")
        check(o["spill_bytes"] == 0, f"{name} spills: {o}")
        check(o["blocks_per_sm"] >= 1, f"{name} does not fit on an SM: {o}")
        warps = o["blocks_per_sm"] * o["threads_per_block"] // 32
        check(warps >= MIN_WGMMA_WARPS, f"{name}: {warps} warps per SM resident, "
                                        f"fewer than {MIN_WGMMA_WARPS}: {o}")
    return occ


def noshift_band_qkv():
    """No-shift inputs in fp32's underflow band (bf16, (1, 128, 256, 2, 64)):
    keys of norm 9.9 to 10 along one direction, queries against it with
    scores near -80 (even rows) or below -126 (odd rows, every weight below
    2^-126: zeros), max |v| = 2^-18 so the headroom rule holds."""
    import torch

    g = torch.Generator("cuda").manual_seed(1)
    u = torch.randn(64, generator=g, device="cuda")
    u = u / u.norm()
    a = 9.9 + 0.1 * torch.rand(1, 256, 2, 1, generator=g, device="cuda")
    k = a * u + 0.01 * torch.randn(1, 256, 2, 64, generator=g, device="cuda")
    qn = torch.where(torch.arange(128, device="cuda") % 2 == 0, 8.0, 12.9)[None, :, None, None]
    q = (-qn * u / (64 ** -0.5 * math.log2(math.e))).expand(1, 128, 2, 64)
    v = torch.randn(1, 256, 2, 64, generator=g, device="cuda")
    v = v * (2.0 ** -18 / v.abs().max())
    return q.bfloat16().contiguous(), k.bfloat16(), v.bfloat16()


def bounded_band_qkv():
    """The bounded softmax's underflow band: numpy default_rng(0) standard
    normals, (1, 256, 256, 2, 64), q x 14 (row bounds overshooting the true
    row max by 104 to 187 log2 units), in bf16."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 256, 2, 64)).astype(np.float32))
               for _ in range(3))
    return (q * 14).cuda().bfloat16(), k.cuda().bfloat16(), v.cuda().bfloat16()


def kernel_case(name, shape, *, rms_normed=True, q_scale=1.0, expect_branch, seed=0,
                inputs=None):
    """Kernel vs plain on one input (make_qkv's, or `inputs`); returns max
    |kernel - plain| and the headroom stats' error."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    q, k, v = inputs or make_qkv(shape, rms_normed=rms_normed, q_scale=q_scale, seed=seed)
    fa.reset_counts()
    got = fa.flash_attention(q, k, v, bounded=True)
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
    # One headroom and one attention launch (kernels 1 and 2) per call.
    check(launches == {"flash_attention": 1, "flash_attention_headroom": 1,
                       "flash_attention_int8": 0},
          f"{name}: launch counters did not rise by one")
    check(branches == {"noshift": int(expect_branch == "noshift"),
                       "online": int(expect_branch == "online")},
          f"{name}: expected the {expect_branch} branch, once")
    return err, stats_err


def online_case(name, shape, *, q_scale, seed):
    """Kernel 2 alone (flash_attention(bounded=False)) vs the plain online
    softmax; returns max |kernel - plain|."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    q, k, v = make_qkv(shape, rms_normed=True, q_scale=q_scale, seed=seed)
    fa.reset_counts()
    got = fa.flash_attention(q, k, v, bounded=False)
    torch.cuda.synchronize()
    launches, branches = dict(fa.LAUNCHES), fa.branch_counts("cuda")
    err, rel, ok = compare(got, fa.flash_attention_plain(q, k, v, bounded=False))
    say(f"  online {name} {shape}: max_abs_err {err:.3e}, rel_l2 {rel:.3e}, launches {launches}, "
        f"branches {branches}")
    check(ok, f"online {name}: kernel 2 disagrees with plain")
    check(launches == {"flash_attention": 1, "flash_attention_headroom": 0,
                       "flash_attention_int8": 0}
          and branches == {"noshift": 0, "online": 1}, f"online {name}: launches {launches}")
    return err


# Kernels 1 and 2 (one launch) at D = 64 and 128, each case in both
# branches: unit-RMS q and k take the no-shift branch, q x 100 the online one.
BRANCH_CASES = (("dit", DIT_SHAPE), ("forward_dit", FWD_DIT_SHAPE),
                ("forward_dit_9_frames", FWD9_DIT_SHAPE), ("dit_d64", (5, 1024, 1024, 32, 64)),
                ("ragged", (2, 1000, 777, 8, 128)), ("ragged_d64", (3, 777, 1000, 16, 64)),
                ("short_keys", (2, 300, 40, 8, 128)), ("short_keys_d64", (2, 70, 100, 4, 64)))


def kernels_phase():
    errs = [kernel_case(f"{name}_{branch}", shape, q_scale=q_scale, expect_branch=branch,
                        seed=i)
            for i, (name, shape) in enumerate(BRANCH_CASES)
            for q_scale, branch in ((1.0, "noshift"), (100.0, "online"))]
    errs += [
        kernel_case("vae_d512", VAE_ENC_SHAPE, rms_normed=False, q_scale=1.0,
                    expect_branch="noshift", seed=2),
        kernel_case("vae_decode_d512", VAE_DEC_SHAPE, rms_normed=False, q_scale=1.0,
                    expect_branch="noshift", seed=6),
        kernel_case("online_d512", (1, 1000, 1200, 1, 512), rms_normed=False, q_scale=100.0,
                    expect_branch="online", seed=5),
        kernel_case("ragged_d512", (1, 1000, 1200, 1, 512), rms_normed=False, q_scale=1.0,
                    expect_branch="noshift", seed=8),
        kernel_case("ragged_d256", (2, 1000, 777, 2, 256), rms_normed=False, q_scale=1.0,
                    expect_branch="noshift", seed=9),
        kernel_case("online_d256", (2, 1000, 777, 2, 256), rms_normed=False, q_scale=100.0,
                    expect_branch="online", seed=10),
        kernel_case("noshift_underflow_band", (1, 128, 256, 2, 64), expect_branch="noshift",
                    inputs=noshift_band_qkv()),
    ]
    online = [online_case("dit", DIT_SHAPE, q_scale=1.0, seed=12),
              online_case("forward_dit", FWD_DIT_SHAPE, q_scale=1.0, seed=13),
              online_case("ragged", (2, 1000, 777, 8, 128), q_scale=30.0, seed=14),
              online_case("ragged_d64", (3, 777, 1000, 16, 64), q_scale=1.0, seed=15),
              online_case("short_keys", (2, 300, 40, 8, 128), q_scale=1.0, seed=16)]
    return max(e for e, _ in errs), max(s for _, s in errs), max(online)


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
    out = fa.flash_attention(q, k, v, bounded=True)
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
           "headroom_ms": headroom, "headroom_bound_ms": headroom_bound(FLAGSHIP_SHAPE)[0],
           "library_ms": library, "plain_ms_2_heads": plain2,
           "online_plain_ms_2_heads": online_plain2, "bound_ms": bound,
           "bound_by": by, "tflops": 4 * b * lq * lk * h * d / kernel / 1e9,
           "max_abs_err_2_heads": err, "rel_l2_2_heads": rel,
           "vs_library": kernel / library, "online_vs_library": online / library,
           "branches": fa.branch_counts("cuda")}
    say("flagship_attention " + json.dumps(rec))
    check(ok, "flagship: kernel disagrees with plain on 2 heads")
    del q, k, v, out, q2, k2, v2, want
    torch.cuda.empty_cache()
    return rec


def flagship_vae_phase():
    """Kernels 1 and 2 at the flagship's VAE attention (8, 14080, 1, 512),
    the wide-head body: the bounded call (no-shift on these inputs) and the
    online branch timed beside SDPA, each checked against the plain version
    on the first batch row (rows of one batch entry depend on it alone)."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    shape = FLAGSHIP_VAE_SHAPE
    q, k, v = make_qkv(shape, rms_normed=False, seed=17)
    stats = fa.flash_headroom(q, k, v)
    fa.reset_counts()
    out = fa.flash_attention(q, k, v, bounded=True)
    online_out = fa.flash_attention(q, k, v, bounded=False)
    torch.cuda.synchronize()
    branches = fa.branch_counts("cuda")
    q1, k1, v1 = (x[:1].contiguous() for x in (q, k, v))
    rec = {"shape": list(shape), "branches": branches,
           "ms": time_ms(lambda: fa.flash_attention_kernel(q, k, v, stats), reps=5, warmup=1),
           "online_ms": time_ms(lambda: fa.flash_attention_kernel(q, k, v, None), reps=5,
                                warmup=1),
           "library_ms": sdpa_ms(q, k, v, reps=5),
           "plain_ms_1_row": time_ms(lambda: fa.flash_attention_plain(q1, k1, v1), reps=1,
                                     warmup=0)}
    oks = []
    for key, got, bounded in (("noshift", out, True), ("online", online_out, False)):
        err, rel, ok = compare(got[:1], fa.flash_attention_plain(q1, k1, v1, bounded=bounded))
        rec[f"{key}_max_abs_err_1_row"], rec[f"{key}_rel_l2_1_row"] = err, rel
        oks.append(ok)
    rec["bound_ms"], rec["bound_by"] = attention_bound(shape, noshift=True)
    rec["online_bound_ms"] = attention_bound(shape, noshift=False)[0]
    rec["vs_library"] = rec["ms"] / rec["library_ms"]
    rec["online_vs_library"] = rec["online_ms"] / rec["library_ms"]
    rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    say("flagship_vae_attention " + json.dumps(rec))
    check(all(oks), "flagship VAE attention: kernel disagrees with plain on the first row")
    check(branches == {"noshift": 1, "online": 1}, f"flagship VAE attention: branches {branches}")
    del q, k, v, stats, out, online_out, q1, k1, v1
    torch.cuda.empty_cache()
    return rec


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def qmm_bound(m, k, n, groups):
    """(bound_ms, bound_by) of one W8A8 matmul: xq, the weight, the scales
    and the dequant read once, the bf16 output written once, against
    2*M*N*K int8 tensor-core operations."""
    t_bytes = (m * k + n * k + 2 * m * n + 4 * n * groups + 4 * m) / PEAK_BYTES
    t_ops = 2 * m * n * k / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def qmm_case(m, k, n, group, *, seed, timed, out_dtype="bfloat16"):
    """Kernel 4 vs its plain version on DiT-like activations and weights
    quantized by the port, writing out_dtype; returns the case's record."""
    import torch
    import torch.nn.functional as F
    from diffusionrenderer_tpu_torch.models.quant import quantize_tensor
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(m, k, generator=g, device="cuda").bfloat16()
    w = (torch.randn(n, k, generator=g, device="cuda") * 0.02).bfloat16()
    leaf = quantize_tensor(w, act_quant=True, group_size=group)
    wq, sa = leaf["q"], leaf["sa"]
    xq, dq = qm.quantize_activation_fp32(x)
    dtype = getattr(torch, out_dtype)
    qm.reset_counts()
    got = qm.quant_matmul_w8a8_kernel(xq, dq, wq, sa, dtype)
    torch.cuda.synchronize()
    launches = qm.LAUNCHES["quant_matmul_w8a8"]
    want = qm.quant_matmul_w8a8_plain(xq, dq, wq, sa, dtype)
    diff = (got.float() - want.float()).abs()
    wmax = want.float().abs().max().item()
    rec = {"shape_mkn": [m, k, n], "group": group, "out_dtype": out_dtype, "launches": launches,
           "bitwise_equal": bool(torch.equal(got, want)), "max_abs_err": diff.max().item(),
           "ulp_of_max": bf16_ulp(wmax),
           "rel_l2": (diff.norm() / want.float().norm()).item()}
    check(launches == 1, f"W8A8 {m, k, n, group}: {launches} launches, expected 1")
    if group is None:
        check(rec["bitwise_equal"], f"W8A8 {m, k, n}: per-channel kernel differs from plain")
    else:
        check(rec["max_abs_err"] <= rec["ulp_of_max"] and rec["rel_l2"] <= 1e-3,
              f"W8A8 {m, k, n, group}: kernel outside one bf16 ulp / rel L2 1e-3 of plain")
    if timed:
        rec["bound_ms"], rec["bound_by"] = qmm_bound(m, k, n, 1 if group is None else k // group)
        rec["ms"] = time_ms(lambda: qm.quant_matmul_w8a8_kernel(xq, dq, wq, sa, torch.bfloat16),
                            20)
        rec["plain_ms"] = time_ms(lambda: qm.quant_matmul_w8a8_plain(xq, dq, wq, sa,
                                                                      torch.bfloat16), 2, 1)
        rec["prepass_ms"] = time_ms(lambda: qm.quantize_activation_fp32(x), 20)
        # Yardsticks: the int32 product alone on the same int8 operands,
        # and the bf16 matmul the quantized one stands in for.
        rec["library_ms"] = time_ms(lambda: torch._int_mm(xq, wq.T), 20)
        rec["linear_bf16_ms"] = time_ms(lambda: F.linear(x, w), 20)
        rec["tops"] = 2 * m * n * k / rec["ms"] / 1e9
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["vs_library"] = rec["ms"] / rec["library_ms"]
    say("  w8a8 " + json.dumps(rec))
    return rec


def qmm_phase():
    recs = []
    for i, (m, k, n) in enumerate(QMM_SHAPES):
        for group in (None, 128):
            recs.append(qmm_case(m, k, n, group, seed=20 + 2 * i + (group is not None),
                                 timed=True))
    for m, k, n, group in ((1000, 4096, 4096, None), (1000, 4096, 4096, 128),
                           (5120, 4096, 4096, 32), (5120, 4096, 4096, 512)):
        recs.append(qmm_case(m, k, n, group, seed=30 + m % 7 + (group or 0), timed=group == 512))
    # The wgmma body's edges: a k32 step across K, partial tiles, one
    # warpgroup's rows, a group spanning two stages, k32 steps past K in
    # grouped mode, and the fp32-output kernels.
    for m, k, n, group, out in ((77, 48, 100, None, "bfloat16"), (64, 4096, 4096, None, "bfloat16"),
                                (64, 4096, 4096, 128, "bfloat16"), (77, 512, 100, 256, "bfloat16"),
                                (1000, 4096, 4096, 256, "bfloat16"), (77, 96, 100, 32, "bfloat16"),
                                (77, 48, 100, None, "float32"), (1000, 4096, 4096, None, "float32"),
                                (1000, 4096, 4096, 128, "float32")):
        recs.append(qmm_case(m, k, n, group, seed=40 + m % 7 + k % 5 + (group or 0),
                             timed=False, out_dtype=out))
    return recs


def fa8_bound(shape, pv8: bool):
    """(bound_ms, bound_by) of one int8 attention call: int8 q, k (+ fp32
    row scales), V (bf16, or int8 + channel scales), the bf16 output;
    2*B*Lq*Lk*H*D int8 QK^T operations, as many PV operations (int8 with
    pv8, bf16 without), and the fp32 softmax work per score (the rank-1
    dequant, max, shift, exp2, sum; pv8 adds the 127 fold and the round)."""
    b, lq, lk, h, d = shape
    nbytes = b * h * (lq * d + lk * d + 4 * (lq + lk) + (lk * d + 4 * d if pv8 else 2 * lk * d)
                      + 2 * lq * d)
    scores = b * lq * lk * h
    t_bytes = nbytes / PEAK_BYTES
    t_mma = 2 * scores * d / PEAK_INT8_OPS + 2 * scores * d / (
        PEAK_INT8_OPS if pv8 else PEAK_BF16_FLOPS)
    t_ops = max(t_mma, (8 if pv8 else 6) * scores / PEAK_FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def int8_vs_exact(got, q, k, v, pv8):
    """(max |got - attention_xla|, its limit, the same error of the plain
    version at the JAX kernel's default key tiling)."""
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops.attention import attention_xla

    exact = attention_xla(q, k, v).float()
    alg = fa.flash_attention_int8_plain(q, k, v, pv_int8=pv8)
    alg_err = (alg.float() - exact).abs().max().item()
    xla_err = (got.float() - exact).abs().max().item()
    return xla_err, max(INT8_XLA_TOL[pv8], 1.1 * alg_err), alg_err


def fa8_case(name, shape, pv8, seed, rms_normed=True):
    """Kernel 5 vs its plain version at the kernel's key tile and vs
    attention_xla; returns (max |kernel - plain|, record)."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    q, k, v = make_qkv(shape, rms_normed=rms_normed, seed=seed)
    fa.reset_counts()
    got = fa.flash_attention(q, k, v, qk_int8=True, pv_int8=pv8)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    want = fa.flash_attention_int8_plain(q, k, v, pv_int8=pv8,
                                         block_k=fa.INT8_BLOCK_K[shape[4]])
    err, rel, ok = compare(got, want)
    xla_err, xla_limit, alg_err = int8_vs_exact(got, q, k, v, pv8)
    rec = {"case": name, "shape": list(shape), "pv_int8": pv8, "max_abs_err": err,
           "tol": MAX_TOL * want.float().abs().max().item(), "rel_l2": rel,
           "xla_max_abs_err": xla_err, "xla_limit": xla_limit,
           "jax_tiling_xla_max_abs_err": alg_err, "launches": launches}
    say("  int8 attention " + json.dumps(rec))
    check(ok, f"{name} pv8={pv8}: int8 kernel disagrees with plain")
    check(xla_err <= xla_limit, f"{name} pv8={pv8}: int8 kernel too far from exact")
    check(launches == {"flash_attention": 0, "flash_attention_headroom": 0,
                       "flash_attention_int8": 1},
          f"{name}: launch counters wrong")
    return err, rec


def fa8_timings(label, shape, *, rms_normed, reps, seed, two_heads=False):
    """Kernel 5's launch alone at one shape (qk8 and qk8+pv8), its
    pre-passes, its plain version (on 2 heads, and held to it there, when
    two_heads), kernel 1 and SDPA on the same inputs, and the bound."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    q, k, v = make_qkv(shape, rms_normed=rms_normed, seed=seed)
    stats = fa.flash_headroom(q, k, v)
    tile = fa.INT8_BLOCK_K[shape[4]]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    rec = {"shape": list(shape), "library_ms": sdpa_ms(q, k, v, reps),
           "library_queued_ms": queued_ms(sdpa, reps),
           "bf16_kernel_ms": time_ms(lambda: fa.flash_attention_kernel(q, k, v, stats), reps)}
    for pv8 in (False, True):
        ops = fa.int8_operands(q, k, v, pv_int8=pv8)
        key = "pv8" if pv8 else "qk8"
        rec[f"{key}_ms"] = time_ms(lambda: fa.flash_attention_int8_launch(ops), reps)
        rec[f"{key}_prepass_ms"] = time_ms(lambda: fa.int8_operands(q, k, v, pv_int8=pv8), reps)
        rec[f"{key}_bound_ms"], rec[f"{key}_bound_by"] = fa8_bound(shape, pv8)
        rec[f"{key}_tops"] = 4 * math.prod(shape) / rec[f"{key}_ms"] / 1e9
        rec[f"{key}_vs_library"] = rec[f"{key}_ms"] / rec["library_ms"]
        launch = lambda: fa.flash_attention_int8_launch(ops)  # noqa: E731
        rec[f"{key}_queued_ms"] = queued_ms(launch, reps)
        rec[f"{key}_queued_vs_library_queued"] = rec[f"{key}_queued_ms"] / rec["library_queued_ms"]
        if not two_heads:
            rec[f"{key}_plain_ms"] = time_ms(lambda: fa.flash_attention_int8_plain(
                q, k, v, pv_int8=pv8, block_k=tile), 2, 1)
        else:
            out = fa.flash_attention_int8_launch(ops)[:, :, :2]
            q2, k2, v2 = (x[:, :, :2].contiguous() for x in (q, k, v))
            t0 = time.perf_counter()
            want = fa.flash_attention_int8_plain(q2, k2, v2, pv_int8=pv8, block_k=tile)
            torch.cuda.synchronize()
            rec[f"{key}_plain_ms_2_heads"] = (time.perf_counter() - t0) * 1e3
            err, rel, ok = compare(out, want)
            xla_err, xla_limit, alg_err = int8_vs_exact(out, q2, k2, v2, pv8)
            rec[f"{key}_2_heads"] = {"max_abs_err": err, "rel_l2": rel,
                                     "xla_max_abs_err": xla_err, "xla_limit": xla_limit,
                                     "jax_tiling_xla_max_abs_err": alg_err}
            check(ok and xla_err <= xla_limit,
                  f"{label} int8 pv8={pv8}: kernel disagrees on 2 heads")
            del out, q2, k2, v2, want
        del ops
    say(f"  int8 attention timings {label} " + json.dumps(rec))
    del q, k, v, stats, qt, kt, vt
    torch.cuda.empty_cache()
    return rec


def fa8_phase():
    """Kernel 5: the DiT and ragged shapes, then timings at the DiT and
    flagship shapes (kernel launch alone; the pre-passes apart)."""
    errs = []
    for pv8 in (False, True):
        errs.append(fa8_case("dit", DIT_SHAPE, pv8, seed=40 + pv8)[0])
        errs.append(fa8_case("ragged", (2, 1000, 777, 4, 128), pv8, seed=42 + pv8)[0])
        # The JAX package's own test shape and inputs (standard normal).
        errs.append(fa8_case("jax_test", (2, 256, 256, 2, 64), pv8, seed=46 + pv8,
                             rms_normed=False)[0])
    timings = {label: fa8_timings(label, shape, rms_normed=True, reps=reps, seed=44,
                                  two_heads=label == "flagship")
               for label, shape, reps in (("dit", DIT_SHAPE, 20),
                                          ("flagship", FLAGSHIP_SHAPE, 3))}
    return max(errs), timings


def warm_calls(call, n: int, pipe):
    """n warm calls of call() (each closed by a synchronize): every wall time
    and ms per denoising step (pipe.timings), their medians and the wall
    time's quartiles."""
    import torch

    walls, steps = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        steps.append(pipe.timings["denoise"] / pipe.num_steps * 1e3)
    q1, med, q3 = (statistics.quantiles(walls, n=4, method="inclusive") if n > 1
                   else walls * 3)
    return {"calls": n, "wall_s": walls, "median_s": med, "q1_s": q1, "q3_s": q3,
            "step_ms": steps, "median_step_ms": statistics.median(steps)}


def main_path_phase(label: str = "bf16", warm: int = 1, **load_kw):
    """load_pipeline(**load_kw) + inverse_render() of the main path's image,
    first call and `warm` warm calls; checks the outputs and every kernel's
    launches."""
    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch.api import INVERSE_PASSES, inverse_render, load_pipeline
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = load_pipeline(**load_kw)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated()
    cfg = get_inverse_renderer_config(512, 512, 1)  # what load_pipeline() builds
    net, vae = cfg.net, cfg.vae
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    say(f"  {label} load_pipeline: {load_s:.2f} s, weights {weights_gib:.2f} GiB on the card, "
        f"load peak {load_peak / 2 ** 30:.2f} GiB ({net.model_channels} wide, "
        f"{net.num_heads} heads, {net.num_blocks} blocks; VAE {vae.encoder_block_out_channels})")
    image = np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)

    # The counts the config implies: one attention call per DiT block per
    # step (guidance 0: one forward per step), plus the VAE mid-block's
    # spatial attention in the one batched encode and the one decode; and,
    # quantized, one W8A8 launch per block matmul (fa wq, wk, wv, wo; mlp
    # w1, w2) per block per step.
    expected = pipe.num_steps * net.num_blocks + 2
    expected_qmm = 6 * net.num_blocks * pipe.num_steps if load_kw.get("act_quant") else 0
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    qm.reset_counts()
    t0 = time.perf_counter()
    out = inverse_render(pipe, image)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**fa.LAUNCHES, **qm.LAUNCHES}
    branches = fa.branch_counts("cuda")
    peak = torch.cuda.max_memory_allocated()
    timings = dict(pipe.timings)
    rec = {"mode": label, "wall_s": wall, "encode_s": timings["encode"],
           "denoise_s": timings["denoise"], "denoise_step_s": timings["denoise"] / pipe.num_steps,
           "decode_s": timings["decode"], "load_s": load_s,
           "load_peak_mem_gib": load_peak / 2 ** 30, "peak_mem_gib": peak / 2 ** 30,
           "weights_gib": weights_gib, "launches": launches, "expected_launches": expected,
           "expected_w8a8_launches": expected_qmm, "branches": branches}
    say(f"main_path_{label} " + json.dumps(rec))
    check(sorted(out) == sorted(INVERSE_PASSES), f"passes {sorted(out)}")
    for name, arr in out.items():
        check(arr.shape == (1, 512, 512, 3), f"{name} shape {arr.shape}")
        check(bool(np.isfinite(arr).all()) and arr.min() >= 0.0 and arr.max() <= 1.0,
              f"{name}: values not finite in [0, 1]")
    # One headroom and one attention launch (kernels 1 and 2) per call, the
    # DiT's D = 128 ones and the VAE's D = 512 ones alike.
    for name in ("flash_attention", "flash_attention_headroom"):
        check(launches[name] == expected, f"{name}: {launches[name]} launches, expected {expected}")
    check(launches["flash_attention_int8"] == 0, "int8 attention ran on the main path")
    check(launches["quant_matmul_w8a8"] == expected_qmm,
          f"quant_matmul_w8a8: {launches['quant_matmul_w8a8']} launches, expected {expected_qmm}")
    check(branches["noshift"] + branches["online"] == expected, "branch counts do not add up")

    # The run above is the first on a fresh process (cuDNN / cuBLAS set-up
    # included); time the same call again, warm.  Not counted.
    warm_rec = warm_calls(lambda: inverse_render(pipe, image), warm, pipe)
    say(f"main_path_{label}_warm " + json.dumps(warm_rec))
    rec["warm"] = warm_rec
    return pipe, rec


def dit_inputs(seed: int):
    """Seeded bf16 DiT inputs at the main path's shape (5 pass rows, one
    512x512 frame's 64x64 latent)."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(5, 1, 64, 64, 16, generator=g, device="cuda").bfloat16()
    cond = torch.randn(5, 1, 64, 64, 16, generator=g, device="cuda").bfloat16()
    return x, torch.full((5,), 2.5, device="cuda"), cond, torch.arange(5, device="cuda")


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


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


def profile_phase(params, label: str = "bf16", net=None, inputs=None, crossattn_emb=None):
    """torch.profiler over one DiT forward at the main path's shape (the
    inverse's 5 rows unless net and inputs say otherwise; crossattn_emb:
    dit_forward's): device time by kernel class, and the device's idle
    share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm

    net = net or get_inverse_renderer_config(512, 512, 1).net
    x, sigma, cond, ctx = inputs or dit_inputs(5)

    def step():
        with torch.no_grad():
            dit_forward(params, x, sigma, cond, ctx, net, crossattn_emb=crossattn_emb)

    # The W8A8 activation pre-passes are generic elementwise kernels; a
    # profiler range around each call attributes their device time.
    prepass = qm.quantize_activation_fp32

    def annotated_prepass(x2):
        with record_function(PREPASS_RANGE):
            return prepass(x2)

    step()
    torch.cuda.synchronize()
    qm.quantize_activation_fp32 = annotated_prepass
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        qm.quantize_activation_fp32 = prepass
    # Device-side events only (kernels, copies, memsets); the CPU-side
    # aten:: events would count their kernels' time a second time.
    classes = {"gemm": 0.0, "int8_matmul": 0.0, "flash_attention": 0.0, "headroom": 0.0,
               "elementwise/other": 0.0}
    top = []
    prepass_ms = 0.0
    for ev in prof.key_averages():
        if ev.key == PREPASS_RANGE:
            # The host-side range sums its kernels' device time; its GPU-side
            # twin spans the same kernels and is not counted again.
            if ev.device_type == DeviceType.CPU:
                prepass_ms = ev.device_time_total / 1e3
            continue
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Command Buffer"):
            continue
        dev_us = (ev.self_device_time_total if hasattr(ev, "self_device_time_total")
                  else ev.self_cuda_time_total)
        dev_ms = dev_us / 1e3
        name, low = ev.key, ev.key.lower()
        if any(w in name for w in ("attention_kernel", "bounded_kernel", "partial_kernel",
                                   "flash_int8", "flash_partial", "flash_bounded")):
            cls = "flash_attention"
        elif "headroom_kernel" in name:
            cls = "headroom"
        elif "w8a8_kernel" in name:
            cls = "int8_matmul"
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
    if crossattn_emb is not None:
        # The general cross-attention: q and o per token, k and v per
        # context token, and its two fp32 products over the M keys.
        ctx_tokens, m = crossattn_emb.shape[0] * crossattn_emb.shape[1], crossattn_emb.shape[1]
        dense_tflop += 2 * net.num_blocks * (tokens * (2 * d * d + 2 * m * d)
                                             + ctx_tokens * 2 * d * crossattn_emb.shape[2]) / 1e12
    mm_ms = classes["gemm"] + classes["int8_matmul"]
    rec = {"mode": label, "wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
           "by_class_ms": classes, "w8a8_prepass_ms_within_elementwise": prepass_ms,
           "dense_matmul_tflop": dense_tflop,
           "matmul_tflops": dense_tflop / (mm_ms / 1e3) if mm_ms else None,
           "top": [[round(t, 3), c, n] for t, c, n in top[:12]]}
    say(f"profile_dit_forward_{label} " + json.dumps(rec))
    return rec


def quant_reference_phase(bf16_params):
    """One full-width W8A8 DiT forward through the kernels, held against
    (a) the same forward with the W8A8 kernel's plain version swapped in for
    the kernel (the attention kernels kept): this isolates kernel 4 in situ;
    (b) the plain path, both the W8A8 and the attention kernels swapped for
    their plain versions; and printed beside the bf16 forward on the same
    weights.  Returns (W8A8 params, record)."""
    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models import quant
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm

    net = get_inverse_renderer_config(512, 512, 1).net
    params = quant.quantize_dit_params(bf16_params, act_quant=True)
    x, sigma, cond, ctx = dit_inputs(3)

    def plain_w8a8(xx, wq, scale):
        *lead, k = xx.shape
        xq, dq = qm.quantize_activation_fp32(xx.reshape(-1, k))
        return qm.quant_matmul_w8a8_plain(xq, dq, wq, scale, xx.dtype).reshape(*lead, -1)

    def forward_plain_w8a8(attn_backend):
        kernel_call, quant.quant_matmul_w8a8 = quant.quant_matmul_w8a8, plain_w8a8
        try:
            return dit_forward(params, x, sigma, cond, ctx, net, attn_backend=attn_backend)
        finally:
            quant.quant_matmul_w8a8 = kernel_call

    with torch.no_grad():
        qm.reset_counts()
        got = dit_forward(params, x, sigma, cond, ctx, net)
        torch.cuda.synchronize()
        launches = qm.LAUNCHES["quant_matmul_w8a8"]
        swapped = forward_plain_w8a8("auto")
        plain = forward_plain_w8a8("xla")
        bf16 = dit_forward(bf16_params, x, sigma, cond, ctx, net)
    rec = {"w8a8_kernel_vs_its_plain_rel_l2": rel_l2(got, swapped),
           "kernel_path_vs_plain_path_rel_l2": rel_l2(got, plain),
           "w8a8_vs_bf16_rel_l2": rel_l2(got, bf16), "w8a8_launches": launches}
    say("quant_reference " + json.dumps(rec))
    check(launches == 6 * net.num_blocks, f"W8A8 forward: {launches} kernel launches")
    check(rec["w8a8_kernel_vs_its_plain_rel_l2"] <= 2e-2,
          "W8A8 forward: the W8A8 kernel moves the forward away from its plain version")
    # With the attention kernels on the plain path too, their bf16 ulps
    # (1.2e-2 after 28 bf16 blocks, phase 8) move int8 activation codes
    # across .5 boundaries at every block matmul: a few 1e-2, the size of
    # the W8A8 quantization noise itself (w8a8_vs_bf16).  A wrong kernel
    # moves the output by O(1).
    check(rec["kernel_path_vs_plain_path_rel_l2"] <= W8A8_PERTURB_TOL,
          "W8A8 forward: kernel path vs plain")
    return params, rec


def int8_attention_path_phase(params):
    """The int8 attention path: one W8A8 DiT forward with
    attn_backend='pallas_pv_int8' (one int8 attention launch per block)
    against attn_backend='pallas'."""
    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    net = get_inverse_renderer_config(512, 512, 1).net
    x, sigma, cond, ctx = dit_inputs(4)
    with torch.no_grad():
        fa.reset_counts()
        got = dit_forward(params, x, sigma, cond, ctx, net, attn_backend="pallas_pv_int8")
        torch.cuda.synchronize()
        launches = dict(fa.LAUNCHES)
        want = dit_forward(params, x, sigma, cond, ctx, net, attn_backend="pallas")
    rec = {"launches": launches, "pv_int8_vs_bf16_attention_rel_l2": rel_l2(got, want),
           "finite": bool(torch.isfinite(got).all())}
    say("int8_attention_path " + json.dumps(rec))
    check(launches["flash_attention_int8"] == net.num_blocks and launches["flash_attention"] == 0,
          f"pallas_pv_int8 forward: launches {launches}")
    check(rec["finite"], "pallas_pv_int8 forward: non-finite output")
    return rec


def prepass_per_forward(qmm_recs):
    """Device ms of the W8A8 activation pre-passes per DiT forward: one per
    block matmul (the same xm is quantized three times for wq/wk/wv)."""
    ms = {tuple(r["shape_mkn"]): r["prepass_ms"] for r in qmm_recs
          if r["group"] is None and "prepass_ms" in r}
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config

    per_block = sum(ms[shape] * n for shape, n in QMM_PER_BLOCK.items())
    return get_inverse_renderer_config(512, 512, 1).net.num_blocks * per_block


def attention_timings(shape, normed: bool, reps: int, two_heads: bool = False):
    """Kernel 1's bounded call, kernel 2's unbounded one, kernel 6 (D <= 128)
    and the headroom kernel at one shape: event and queued times beside
    F.scaled_dot_product_attention, the plain versions (on 2 heads when
    two_heads), the bounds and the host time of a call."""
    import torch
    import torch.nn.functional as F
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    q, k, v = make_qkv(shape, rms_normed=normed, seed=11)
    stats = fa.flash_headroom(q, k, v)
    noshift = bool(fa.use_noshift(stats, shape[0] * shape[3], shape[2], shape[4]))
    bound, by = attention_bound(shape, noshift)
    call = lambda: fa.flash_attention_kernel(q, k, v, stats)  # noqa: E731
    online = lambda: fa.flash_attention_kernel(q, k, v, None)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    pq, pk, pv = (x[:, :, :2].contiguous() for x in (q, k, v)) if two_heads else (q, k, v)
    plain_reps = (1, 0) if two_heads else (2, 1)
    suffix = "_2_heads" if two_heads else ""
    rec = {"shape": list(shape), "branch": "noshift" if noshift else "online",
           "ms": time_ms(call, reps), "bound_ms": bound, "bound_by": by,
           f"plain_ms{suffix}": time_ms(lambda: fa.flash_attention_plain(pq, pk, pv), *plain_reps),
           "library_ms": sdpa_ms(q, k, v, reps),
           # The online branch on the same inputs (stats=None forces it).
           "online_ms": time_ms(online, reps),
           f"online_plain_ms{suffix}": time_ms(
               lambda: fa.flash_attention_plain(pq, pk, pv, bounded=False), *plain_reps),
           "online_bound_ms": attention_bound(shape, noshift=False)[0],
           # The same, timed with the launches queued ahead: event times
           # of the small shapes read the host's launch rate.
           "queued_ms": queued_ms(call, reps), "online_queued_ms": queued_ms(online, reps),
           "library_queued_ms": queued_ms(sdpa, reps),
           "call_host_us": host_us(call, 20 if two_heads else 200),
           "online_call_host_us": host_us(online, 20 if two_heads else 200)}
    if shape[4] <= 128:  # kernel 6 at the wide heads: phase 18
        mb = fa.row_bound(q, k)
        pipe = lambda: fa.flash_attention_bounded_kernel(q, k, v, mb, pipelined=True)  # noqa: E731
        rec.update({"kernel6_ms": time_ms(pipe, reps), "kernel6_queued_ms": queued_ms(pipe, reps),
                    "kernel6_bound_ms": bounded_bound(shape)[0],
                    f"kernel6_plain_ms{suffix}": time_ms(
                        lambda: fa.flash_attention_bounded_plain(pq, pk, pv), *plain_reps),
                    "row_bound_ms": time_ms(lambda: fa.row_bound(q, k), reps)})
    for key in ("", "online_", "kernel6_"):
        if f"{key}ms" in rec:
            rec[f"{key}vs_library"] = rec[f"{key}ms"] / rec["library_ms"]
            rec[f"{key}queued_vs_library_queued"] = (rec[f"{key}queued_ms"]
                                                     / rec["library_queued_ms"])
    hbound, hby = headroom_bound(shape)
    head = {"shape": list(shape), "ms": time_ms(lambda: fa.flash_headroom(q, k, v), reps),
            "plain_ms": time_ms(lambda: fa.headroom_stats_plain(q, k, v), *plain_reps),
            "library_ms": None, "bound_ms": hbound, "bound_by": hby}
    say(f"  attention timings {shape} " + json.dumps(rec))
    del q, k, v, stats, qt, kt, vt, pq, pk, pv
    torch.cuda.empty_cache()
    return rec, head


def kernel_records(main_rec, errs, quant, var, occ, flagship_vae):
    """Per-kernel numbers at the main path's shapes.  `errs` = phase 3's
    (kernels 1 and 2 / bounded call, headroom stats, kernel 2 alone) errors,
    `quant` carries the int8 kernels' numbers from phases 5, 6, 10 and 12,
    `var` kernels 3, 6 and 7's from phases 14 to 18, `occ` phase 2's
    occupancy, `flagship_vae` phase 4's wide-head numbers."""
    attn_shapes, head_shapes = [], []
    for shape, normed, reps in ((DIT_SHAPE, True, 20), (VAE_ENC_SHAPE, False, 5),
                                (VAE_DEC_SHAPE, False, 5), (FWD_DIT_SHAPE, True, 20),
                                (FWD9_DIT_SHAPE, True, 20)):
        rec, head = attention_timings(shape, normed, reps)
        attn_shapes.append(rec)
        head_shapes.append(head)
    flagship, _ = attention_timings(FLAGSHIP_SHAPE, True, 3, two_heads=True)
    src = "diffusionrenderer_tpu_torch/csrc/flash_attention_wgmma.cu"
    src_wide = src + " attention_kernel_wide<D> (attend_wide"
    main = main_rec["launches"]
    dit = attn_shapes[0]
    by_shape = attn_shapes + [flagship]
    online_keys = ("online_ms", "online_plain_ms", "online_plain_ms_2_heads", "online_bound_ms",
                   "library_ms", "online_vs_library", "online_queued_ms", "library_queued_ms",
                   "online_queued_vs_library_queued", "online_call_host_us")
    kernel6_keys = ("kernel6_ms", "kernel6_plain_ms", "kernel6_plain_ms_2_heads",
                    "kernel6_bound_ms", "library_ms", "kernel6_vs_library", "kernel6_queued_ms",
                    "library_queued_ms", "kernel6_queued_vs_library_queued", "row_bound_ms")
    records = [
        {"name": "flash_attention", "route": "cuda", "source": src,
         "source_d256_d512": src_wide + "<D, kNoShift>)",
         "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:185 (_flash_kernel_noshift)",
         "launches": main["flash_attention"], "launches_by_branch": main_rec["branches"],
         "launches_note": "one launch holds kernels 1 and 2; its blocks take the branch "
                          "the headroom rule picks",
         "max_abs_err": errs[0], **dit, "occupancy_d128": occ["kernel12_attention_d128"],
         "occupancy_d512": occ["kernel12_attention_d512"],
         "main_path_shapes": attn_shapes, "flagship": flagship,
         "flagship_vae": {k_: v_ for k_, v_ in flagship_vae.items() if not k_.startswith("online")}},
        {"name": "flash_attention_online", "route": "cuda", "source": src,
         "source_d256_d512": src_wide + "<D, kOnline>)",
         "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:58 (_flash_kernel, "
                     "_flash_kernel_nobias :116; pallas_call :478, :675)",
         "launches": main["flash_attention"], "launches_by_branch": main_rec["branches"],
         "launches_note": "the launch of kernel 1's row; the online branch runs where the "
                          "headroom rule picks it (branch tally), and in every unbounded call",
         "max_abs_err": max(errs[0], errs[2]), "shape": dit["shape"],
         "ms": dit["online_ms"], "plain_ms": dit["online_plain_ms"],
         "bound_ms": dit["online_bound_ms"], "bound_by": "operations",
         "library_ms": dit["library_ms"], "library": "F.scaled_dot_product_attention bf16",
         "occupancy_d128": occ["kernel12_attention_d128"],
         "occupancy_d512": occ["kernel12_attention_d512"],
         "main_path_shapes": [{"shape": r["shape"], **{k_: r[k_] for k_ in online_keys if k_ in r}}
                              for r in by_shape],
         "flagship_vae": {k_: flagship_vae[k_] for k_ in ("shape", "online_ms", "library_ms",
                                                          "online_bound_ms", "online_vs_library",
                                                          "online_max_abs_err_1_row")}},
        {"name": "flash_attention_headroom", "route": "cuda",
         "source": "diffusionrenderer_tpu_torch/csrc/flash_attention.cu headroom_kernel",
         "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:488 (the headroom rule "
                     "_bounded_cond_call evaluates before its lax.cond; bound at :559)",
         "launches": main["flash_attention_headroom"], "max_abs_err": errs[1],
         **head_shapes[0], "main_path_shapes": head_shapes},
        w8a8_record(quant, occ),
        int8_attention_record(quant, occ),
        *variant_records(var, occ, [{"shape": r["shape"], **{k_: r[k_] for k_ in kernel6_keys
                                                             if k_ in r}}
                                     for r in by_shape if "kernel6_ms" in r]),
    ]
    return records


def w8a8_record(quant, occ):
    """Kernel 4 at the DiT's (5120, 4096, 4096) per-channel matmul, its
    other main-path shapes and modes beside it."""
    timed = [r for r in quant["qmm"] if "ms" in r]
    head = timed[0]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "linear_bf16_ms",
            "prepass_ms")
    return {"name": "quant_matmul_w8a8", "route": "cuda",
            "source": "diffusionrenderer_tpu_torch/csrc/quant_matmul.cu",
            "body": "wgmma m64n256k32 (per channel) / m64n128k32 (grouped) s8, TMA, "
                    "4-stage mbarrier ring, producer warp",
            "replaces": "diffusionrenderer_tpu/ops/quant_matmul.py:70 (_kernel, "
                        "pallas_call at :230)",
            "launches": quant["w8a8"]["launches"]["quant_matmul_w8a8"],
            "launches_w8a8_g128": quant["w8a8_g128"]["launches"]["quant_matmul_w8a8"],
            "max_abs_err": max(r["max_abs_err"] for r in quant["qmm"]),
            **{k: head[k] for k in keys}, "library": "torch._int_mm (int32 product only)",
            "main_path_shapes": [{k: r[k] for k in ("shape_mkn", "group", "tops",
                                                    "share_of_bound", "vs_library", *keys)}
                                 for r in timed],
            "occupancy": {k: v for k, v in occ.items() if k.startswith("kernel4")},
            "prepass_ms_per_dit_forward": quant["prepass_ms_per_forward"]}


def int8_attention_record(quant, occ):
    """Kernel 5 at the DiT shape, int8 QK^T + PV (attn_backend
    'pallas_pv_int8'); qk8 and the flagship shape beside it."""
    dit = quant["fa8_timings"]["dit"]
    return {"name": "flash_attention_int8", "route": "cuda",
            "source": "diffusionrenderer_tpu_torch/csrc/flash_attention_int8.cu",
            "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:317 (_flash_kernel_int8)",
            "launches": quant["int8_path"]["launches"]["flash_attention_int8"],
            "max_abs_err": quant["fa8_max_err"], "ms": dit["pv8_ms"],
            "plain_ms": dit["pv8_plain_ms"], "bound_ms": dit["pv8_bound_ms"],
            "bound_by": dit["pv8_bound_by"], "library_ms": dit["library_ms"],
            "library": "F.scaled_dot_product_attention bf16", "shape": list(DIT_SHAPE),
            "prepass_ms": dit["pv8_prepass_ms"], "timings": quant["fa8_timings"],
            "occupancy": {k: v for k, v in occ.items() if k.startswith("kernel5")}}


# ---------------------------------------------------------------------------
# Kernels 3, 6 and 7 and the sharded path
# ---------------------------------------------------------------------------

def partial_bound(shape):
    """(bound_ms, bound_by) of one partial-stats call: the attention's bytes
    plus m and l written (2 fp32 per query row), against the bf16 products
    and the online softmax's fp32 work per score (max, shift, exp2, sum)."""
    b, lq, lk, h, d = shape
    nbytes = (2 * lq + 2 * lk) * b * h * d * 2 + 2 * b * h * lq * 4
    scores = b * lq * lk * h
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(4 * scores * d / PEAK_BF16_FLOPS, 4 * scores / PEAK_FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bounded_bound(shape):
    """(bound_ms, bound_by) of one bounded-shift call: the attention's bytes
    plus the fp32 row bound read, against the bf16 products and 3 fp32
    operations per score (the shift, exp2, the sum)."""
    b, lq, lk, h, d = shape
    nbytes = (2 * lq + 2 * lk) * b * h * d * 2 + b * h * lq * 4
    scores = b * lq * lk * h
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(4 * scores * d / PEAK_BF16_FLOPS, 3 * scores / PEAK_FP32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def variant_case(name, shape, *, rms_normed=True, seed=0, inputs=None, split=False):
    """Kernels 3, 6 and 7 vs their plain versions on one input (make_qkv's,
    or `inputs`); kernel 6 bitwise against kernel 7 (the wgmma bodies: at D
    = 64 and 128 l summed in key order and PV issued in k16 order whatever
    the tile, at 256 and 512 one schedule); `split`: whether kernels 3, 6
    and 7 split the keys over 2-block clusters here (D = 256, 512, where
    that saves waves), and where they do, the unsplit launches also against
    the plain versions; at D = 256 and 512 kernel 3 with the split forced
    on, where two key tiles allow it; kernel 3's unsplit output bitwise
    against the unbounded call at every head dim (kernel 2's online body).
    Returns the case's record."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    q, k, v = inputs or make_qkv(shape, rms_normed=rms_normed, seed=seed)
    fa.reset_counts()
    out, m, l = fa.flash_attention_partial(q, k, v)
    pipe = fa.flash_attention(q, k, v, bounded=True, pipelined=True)
    shift = fa.flash_attention_bounded_shift(q, k, v)
    torch.cuda.synchronize()
    launches = {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES}
    branches = fa.branch_counts("cuda")
    rec = {"case": name, "shape": list(shape), "launches": launches, "branches": branches,
           "kernel6_bitwise_kernel7": bool(torch.equal(pipe, shift)),
           "key_split": {"kernel6": fa.bounded_key_split(q, k, pipelined=True),
                         "kernel7": fa.bounded_key_split(q, k, pipelined=False),
                         "kernel3": fa.partial_key_split(q, k)}}
    oks = {}
    bounded_plain = fa.flash_attention_bounded_plain(q, k, v)
    partial_plain = fa.flash_attention_partial_plain(q, k, v)
    unsplit = fa.flash_attention_partial_kernel(q, k, v, key_split=False)
    keys = ["partial_out", "partial_m", "partial_l", "bounded", "kernel6", "kernel6_vs_kernel7"]
    gots = [out, m, l, shift, pipe, pipe]
    wants = [*partial_plain, bounded_plain, bounded_plain, shift]
    if split:
        mb = fa.row_bound(q, k)
        keys += ["kernel6_unsplit", "kernel7_unsplit"]
        gots += [fa.flash_attention_bounded_kernel(q, k, v, mb, pipelined=p, key_split=False)
                 for p in (True, False)]
        wants += [bounded_plain, bounded_plain]
        keys += ["partial_out_unsplit", "partial_m_unsplit", "partial_l_unsplit"]
        gots += list(unsplit)
        wants += list(partial_plain)
    d = shape[-1]
    if d in fa.WIDE_BLOCK_K and shape[2] > fa.WIDE_BLOCK_K[d]:  # two key tiles or more
        keys += ["partial_out_split", "partial_m_split", "partial_l_split"]
        gots += list(fa.flash_attention_partial_kernel(q, k, v, key_split=True))
        wants += list(partial_plain)
    for key, got, want in zip(keys, gots, wants):
        err, rel, oks[key] = compare(got, want)
        rec[key] = {"max_abs_err": err, "tol": MAX_TOL * want.float().abs().max().item(),
                    "rel_l2": rel}
    rec["partial_bitwise_online"] = bool(torch.equal(unsplit[0], fa.flash_attention(q, k, v)))
    say("  variants " + json.dumps(rec))
    check(all(oks.values()), f"{name}: kernel 3, 6 or 7 disagrees: {oks}")
    check(rec["kernel6_bitwise_kernel7"], f"{name}: kernel 6 is not bitwise equal to kernel 7")
    check(launches == {"flash_attention": 0, "flash_attention_headroom": 0,
                       "flash_attention_int8": 0, "flash_attention_partial": 1,
                       "flash_attention_bounded_pipe": 1, "flash_attention_bounded": 1},
          f"{name}: launch counters wrong")
    check(branches == {"noshift": 0, "online": 0}, f"{name}: the branch tally moved")
    check(rec["key_split"] == {"kernel6": split, "kernel7": split, "kernel3": split},
          f"{name}: key split {rec['key_split']}, expected {split}")
    check(rec["partial_bitwise_online"],
          f"{name}: kernel 3's unsplit output is not bitwise the unbounded call's")
    return rec


def variants_phase():
    recs = [variant_case("dit", DIT_SHAPE, seed=50),
            variant_case("forward_dit", FWD_DIT_SHAPE, seed=56),
            variant_case("forward_dit_9_frames", FWD9_DIT_SHAPE, seed=57),
            variant_case("dit_d64", (5, 1024, 1024, 32, 64), seed=58),
            variant_case("vae_d512", VAE_ENC_SHAPE, rms_normed=False, seed=51, split=True),
            variant_case("vae_decode_d512", VAE_DEC_SHAPE, rms_normed=False, seed=62,
                         split=True),
            variant_case("d256", D256_SHAPE, seed=63),
            variant_case("ragged_d256", (1, 1000, 777, 2, 256), seed=64, split=True),
            variant_case("short_keys_d512", (2, 300, 20, 1, 512), rms_normed=False, seed=65),
            variant_case("ragged", (2, 1000, 777, 8, 128), seed=52),
            variant_case("ragged_d64", (3, 777, 1000, 16, 64), seed=59),
            variant_case("short_keys", (2, 300, 40, 8, 128), seed=60),
            variant_case("short_keys_d64", (2, 70, 100, 4, 64), seed=61),
            variant_case("ragged_d512", (1, 1000, 1200, 1, 512), rms_normed=False, seed=53,
                         split=True),
            variant_case("underflow_band", (1, 256, 256, 2, 64), inputs=bounded_band_qkv())]
    return max(max(v["max_abs_err"] for v in r.values() if isinstance(v, dict)
                   and "max_abs_err" in v) for r in recs), recs


def ring_merge_phase(shape=FLAGSHIP_SHAPE, shards: int = 4, seed: int = 54):
    """The ring's merge on one card: kernel 3 over each of `shards` key
    shards of `shape`, combined by parallel.ring_attention._merge and
    normalized, against kernel 2 over all keys."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.parallel.ring_attention import _merge, _partial_attn_flash

    q, k, v = make_qkv(shape, rms_normed=True, seed=seed)
    lk = k.shape[1]
    state = None
    for i in range(shards):
        a, z = i * lk // shards, (i + 1) * lk // shards
        part = _partial_attn_flash(q, k[:, a:z].contiguous(), v[:, a:z].contiguous())
        state = part if state is None else _merge(state, part)
    _, l, o = state
    got = (o / l.permute(0, 2, 1)[..., None]).to(q.dtype)
    want = fa.flash_attention_kernel(q, k, v, None)
    err, rel, ok = compare(got, want)
    rec = {"shape": list(shape), "shards": shards, "max_abs_err": err,
           "tol": MAX_TOL * want.float().abs().max().item(), "rel_l2": rel}
    say("ring_merge " + json.dumps(rec))
    check(ok, "ring merge of kernel-3 shards disagrees with kernel 2's exact attention")
    del q, k, v, state, l, o, got, want
    torch.cuda.empty_cache()
    return rec


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_main_path_phase(unsharded_warm_s: float, warm: int):
    """A one-rank NCCL group, then the sharded inverse render with ring
    attention at full width, first call and `warm` warm calls; returns
    (pipe, mesh, record)."""
    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch.api import INVERSE_PASSES, inverse_render, load_pipeline
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    import torch.distributed as dist

    check(dist.get_backend() == "nccl", f"process group backend {dist.get_backend()}, not nccl")
    mesh = make_mesh(1, data=1, seq=1, tensor=1)
    pipe = load_pipeline().shard(mesh, sp_attn="ring")
    net = get_inverse_renderer_config(512, 512, 1).net
    image = np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    expected = pipe.num_steps * net.num_blocks
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    t0 = time.perf_counter()
    out = inverse_render(pipe, image)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES}
    rec = {"mode": "sharded_ring_1rank", "backend": dist.get_backend(), "wall_s": wall,
           **{f"{k}_s": v for k, v in pipe.timings.items()},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "expected_partial_launches": expected,
           "branches": fa.branch_counts("cuda")}
    check(sorted(out) == sorted(INVERSE_PASSES), f"passes {sorted(out)}")
    for name, arr in out.items():
        check(arr.shape == (1, 512, 512, 3), f"{name} shape {arr.shape}")
        check(bool(np.isfinite(arr).all()) and arr.min() >= 0.0 and arr.max() <= 1.0,
              f"{name}: values not finite in [0, 1]")
    check(launches["flash_attention_partial"] == expected,
          f"kernel 3: {launches['flash_attention_partial']} launches, expected {expected}")
    # The VAE's mid-block attention (encode and decode) keeps kernel 1.
    check(launches["flash_attention"] == 2 and launches["flash_attention_headroom"] == 2,
          f"VAE attention launches {launches}")
    rec["warm"] = warm_calls(lambda: inverse_render(pipe, image), warm, pipe)
    rec["unsharded_warm_wall_s"] = unsharded_warm_s
    rec["warm_vs_unsharded"] = rec["warm"]["median_s"] / unsharded_warm_s
    say("main_path_sharded " + json.dumps(rec))
    return pipe, mesh, rec


def sharded_forward_phase(pipe, mesh):
    """One DiT forward on the sharded ring path and one with 'flash_sp',
    against the unsharded kernel path ('auto') and, bitwise, against the
    unsharded 'pallas_onlinemax' forward (kernel 2 on the same operands)."""
    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    net = get_inverse_renderer_config(512, 512, 1).net
    x, sigma, cond, ctx = dit_inputs(6)
    params = pipe.dit_params
    with torch.no_grad():
        base = dit_forward(params, x, sigma, cond, ctx, net)
        fa.reset_counts()
        ring = dit_forward(params, x, sigma, cond, ctx, net, attn_backend="ring", mesh=mesh)
        torch.cuda.synchronize()
        ring_launches = fa.VARIANT_LAUNCHES["flash_attention_partial"]
        fa.reset_counts()
        sp = dit_forward(params, x, sigma, cond, ctx, net, attn_backend="flash_sp", mesh=mesh)
        torch.cuda.synchronize()
        sp_launches = dict(fa.LAUNCHES)
        sp_branches = fa.branch_counts("cuda")
        online = dit_forward(params, x, sigma, cond, ctx, net, attn_backend="pallas_onlinemax")
    rec = {"ring_vs_unsharded_rel_l2": rel_l2(ring, base), "ring_kernel3_launches": ring_launches,
           "flash_sp_bitwise_pallas_onlinemax": bool(torch.equal(sp, online)),
           "flash_sp_launches": sp_launches, "flash_sp_branches": sp_branches,
           "finite": bool(torch.isfinite(ring).all() and torch.isfinite(sp).all())}
    say("sharded_forward " + json.dumps(rec))
    check(ring_launches == net.num_blocks, f"ring forward: {ring_launches} kernel-3 launches")
    check(rec["finite"], "sharded forward: non-finite output")
    check(rec["ring_vs_unsharded_rel_l2"] <= 2e-2, "ring forward vs unsharded kernel path")
    check(sp_launches["flash_attention"] == net.num_blocks
          and sp_launches["flash_attention_headroom"] == 0
          and sp_branches == {"noshift": 0, "online": net.num_blocks},
          f"flash_sp forward: launches {sp_launches}, branches {sp_branches}")
    check(rec["flash_sp_bitwise_pallas_onlinemax"],
          "flash_sp forward is not bitwise equal to the pallas_onlinemax forward")
    return rec


def bounded_forward_phase(params):
    """The bounded-shift entry points on the DiT: one forward with
    flash_attention(bounded=True, pipelined=True) as its attention (kernel
    6), one with flash_attention_bounded_shift (kernel 7), both on the wgmma
    body at D = 128: bitwise equal to each other, and within bf16 noise of
    the kernel path's forward (relative L2 2e-2, the limit for 28 bf16
    blocks that phases 8 and 16 use)."""
    import functools

    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    net = get_inverse_renderer_config(512, 512, 1).net
    x, sigma, cond, ctx = dit_inputs(7)
    with torch.no_grad():
        base = dit_forward(params, x, sigma, cond, ctx, net)
        fa.reset_counts()
        pipe = dit_forward(params, x, sigma, cond, ctx, net,
                           attn_backend=functools.partial(fa.flash_attention, bounded=True,
                                                          pipelined=True))
        torch.cuda.synchronize()
        pipe_launches = dict(fa.VARIANT_LAUNCHES)
        fa.reset_counts()
        shift = dit_forward(params, x, sigma, cond, ctx, net,
                            attn_backend=fa.flash_attention_bounded_shift)
        torch.cuda.synchronize()
        shift_launches = dict(fa.VARIANT_LAUNCHES)
    rec = {"kernel6_launches": pipe_launches["flash_attention_bounded_pipe"],
           "kernel7_launches": shift_launches["flash_attention_bounded"],
           "bitwise_equal": bool(torch.equal(pipe, shift)),
           "kernel6_vs_kernel7_rel_l2": rel_l2(pipe, shift),
           "vs_kernel_path_rel_l2": rel_l2(shift, base),
           "kernel6_vs_kernel_path_rel_l2": rel_l2(pipe, base),
           "finite": bool(torch.isfinite(shift).all() and torch.isfinite(pipe).all())}
    say("bounded_forward " + json.dumps(rec))
    check(rec["kernel6_launches"] == net.num_blocks and rec["kernel7_launches"] == net.num_blocks,
          f"bounded forwards: launches {pipe_launches} / {shift_launches}")
    check(rec["bitwise_equal"], "the kernel-6 forward is not bitwise equal to the kernel-7 forward")
    check(rec["finite"] and rec["vs_kernel_path_rel_l2"] <= 2e-2
          and rec["kernel6_vs_kernel_path_rel_l2"] <= 2e-2, "bounded forwards vs the kernel path")
    return rec


# Kernels 3, 6 and 7 at the wide heads (on the wide wgmma body; no render
# launches them): the VAE's encode, decode and flagship shapes at D = 512
# and D = 256 at 8 heads; reps each.
WIDE_VARIANT_SHAPES = (("vae_encode_d512", VAE_ENC_SHAPE, 20), ("vae_decode_d512", VAE_DEC_SHAPE, 10),
                       ("flagship_vae_d512", FLAGSHIP_VAE_SHAPE, 3), ("d256", D256_SHAPE, 20))


def library_lse(qt, kt, vt, reps: int):
    """(ms, None) of PyTorch's one call returning attention's output with its
    log-sum-exp (what kernel 3 returns, up to the log base) on (B, H, L, D)
    views: the flash kernel where it takes the head dim (D <= 256), else the
    memory-efficient one; (None, the refusal) where neither takes it."""
    import torch

    aten = torch.ops.aten
    if qt.shape[-1] <= 256:
        return time_ms(lambda: aten._scaled_dot_product_flash_attention(qt, kt, vt), reps), None
    call = lambda: aten._scaled_dot_product_efficient_attention(  # noqa: E731
        qt, kt, vt, None, True)
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, (f"aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True) "
                      f"refused D = {qt.shape[-1]}: {str(e).splitlines()[0][:200]}")
    return time_ms(call, reps), None


def variant_timings_phase():
    """Kernels 3, 6 and 7 (and kernel 2) at the DiT and flagship shapes and
    at WIDE_VARIANT_SHAPES, their plain versions (2 heads at the flagship
    shape, the first batch row at the flagship VAE's), the row bound's
    pre-pass, and the yardsticks: aten._scaled_dot_product_flash_attention
    (output with its log-sum-exp) for kernel 3 at D <= 256, at D = 512
    aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True)
    where the card's PyTorch takes that head dim (else None and the reason),
    F.scaled_dot_product_attention for kernels 6 and 7.  At the wide heads
    also kernel 1's launch (the headroom rule picks no-shift on these
    inputs), and kernels 3, 6 and 7 with the key split forced on and off."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    recs = {}
    for label, shape, reps in (("dit", DIT_SHAPE, 20), ("flagship", FLAGSHIP_SHAPE, 5),
                               *WIDE_VARIANT_SHAPES):
        q, k, v = make_qkv(shape, rms_normed=True, seed=55)
        mb = fa.row_bound(q, k)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bounded = lambda pipelined, split=None: fa.flash_attention_bounded_kernel(  # noqa: E731
            q, k, v, mb, pipelined=pipelined, key_split=split)
        rec = {"shape": list(shape),
               "kernel3_ms": time_ms(lambda: fa.flash_attention_partial_kernel(q, k, v), reps),
               "kernel6_ms": time_ms(lambda: bounded(True), reps),
               "kernel7_ms": time_ms(lambda: bounded(False), reps),
               "kernel2_ms": time_ms(lambda: fa.flash_attention_kernel(q, k, v, None), reps),
               "row_bound_ms": time_ms(lambda: fa.row_bound(q, k), reps),
               "library_ms": sdpa_ms(q, k, v, reps)}
        rec["library_lse_ms"], note = library_lse(qt, kt, vt, reps)
        if note:
            rec["library_lse_note"] = note
        rec["kernel3_bound_ms"], rec["kernel3_bound_by"] = partial_bound(shape)
        rec["bounded_bound_ms"], rec["bounded_bound_by"] = bounded_bound(shape)
        if shape[-1] > 128:
            stats = fa.flash_headroom(q, k, v)
            rec["kernel1_branch"] = ("noshift" if bool(fa.use_noshift(stats, shape[0] * shape[3],
                                                                       shape[2], shape[4]))
                                     else "online")
            rec["kernel1_ms"] = time_ms(lambda: fa.flash_attention_kernel(q, k, v, stats), reps)
            rec["key_split"] = fa.bounded_key_split(q, k)
            rec["kernel3_key_split"] = fa.partial_key_split(q, k)
            for key, pipelined in (("kernel6", True), ("kernel7", False)):
                for mode, split in (("split", True), ("unsplit", False)):
                    rec[f"{key}_{mode}_ms"] = time_ms(lambda: bounded(pipelined, split), reps)
            for mode, split in (("split", True), ("unsplit", False)):
                rec[f"kernel3_{mode}_ms"] = time_ms(
                    lambda: fa.flash_attention_partial_kernel(q, k, v, key_split=split), reps)
            del stats
        if label == "flagship":
            q2, k2, v2 = (x[:, :, :2].contiguous() for x in (q, k, v))
            rec["kernel3_plain_ms_2_heads"] = time_ms(
                lambda: fa.flash_attention_partial_plain(q2, k2, v2), 1, warmup=0)
            rec["bounded_plain_ms_2_heads"] = time_ms(
                lambda: fa.flash_attention_bounded_plain(q2, k2, v2), 1, warmup=0)
            del q2, k2, v2
        elif label == "flagship_vae_d512":
            q1, k1, v1 = (x[:1].contiguous() for x in (q, k, v))
            rec["kernel3_plain_ms_1_row"] = time_ms(
                lambda: fa.flash_attention_partial_plain(q1, k1, v1), 1, warmup=0)
            rec["bounded_plain_ms_1_row"] = time_ms(
                lambda: fa.flash_attention_bounded_plain(q1, k1, v1), 1, warmup=0)
            del q1, k1, v1
        else:
            rec["kernel3_plain_ms"] = time_ms(lambda: fa.flash_attention_partial_plain(q, k, v),
                                              2, warmup=1)
            rec["bounded_plain_ms"] = time_ms(lambda: fa.flash_attention_bounded_plain(q, k, v),
                                              2, warmup=1)
        b, lq, lk, h, d = shape
        for key in ("kernel3", "kernel6", "kernel7", "kernel2"):
            rec[f"{key}_tflops"] = 4 * b * lq * lk * h * d / rec[f"{key}_ms"] / 1e9
        rec["kernel3_vs_library"] = (rec["kernel3_ms"] / rec["library_lse_ms"]
                                     if rec["library_lse_ms"] else None)
        rec["kernel3_share_of_bound"] = rec["kernel3_bound_ms"] / rec["kernel3_ms"]
        for key in ("kernel6", "kernel7"):
            rec[f"{key}_vs_library"] = rec[f"{key}_ms"] / rec["library_ms"]
            rec[f"{key}_share_of_bound"] = rec["bounded_bound_ms"] / rec[f"{key}_ms"]
        say(f"  variant timings {label} " + json.dumps(rec))
        recs[label] = rec
        del q, k, v, mb, qt, kt, vt
        torch.cuda.empty_cache()
    return recs


def variant_records(var, occ, kernel6_shapes):
    """Rows 3, 6 and 7 of the kernel table: the DiT shape's numbers, the
    flagship's beside them, and the wide heads' (on the wide wgmma body,
    beside kernel 1's launch there and, for kernel 3, kernel 2's online
    one); kernel 6 also at phase 23's shapes."""
    src = "diffusionrenderer_tpu_torch/csrc/flash_attention_wgmma.cu"
    dit, flag = var["timings"]["dit"], var["timings"]["flagship"]
    sharded = var["sharded"]
    common = {"route": "cuda", "source": src, "max_abs_err": var["max_err"],
              "shape": list(DIT_SHAPE)}

    def wide(*keys):
        return {label: {k: var["timings"][label][k] for k in ("shape", *keys, "library_ms")
                        if k in var["timings"][label]}
                for label, _, _ in WIDE_VARIANT_SHAPES}

    def bounded_wide(key):  # kernels 6 and 7 on attend_wide
        mode = "kBoundedPipe" if key == "kernel6" else "kBounded"
        counter = "flash_attention_bounded_pipe" if key == "kernel6" else "flash_attention_bounded"
        # Phase 14's public calls (flash_attention(bounded=True, pipelined=True),
        # flash_attention_bounded_shift), the counters reset before each case.
        wide_cases = [c for c in var["cases"] if c["shape"][-1] > 128]
        return {"source": f"{src} bounded_kernel_wide<D, {mode}> (attend_wide)",
                "by_shape": wide(f"{key}_ms", f"{key}_split_ms", f"{key}_unsplit_ms", "key_split",
                                 "bounded_bound_ms", "bounded_bound_by", "bounded_plain_ms",
                                 "bounded_plain_ms_1_row", "kernel1_ms", "kernel1_branch",
                                 f"{key}_vs_library"),
                "launches_phase_14": {c["case"]: c["launches"][counter] for c in wide_cases},
                "key_split_phase_14": {c["case"]: c["key_split"][key] for c in wide_cases},
                "earlier": "PERF.md section 6 (the times of the mma.sync body this replaced)"}

    return [
        {"name": "flash_attention_partial", **common,
         "source": src + " partial_kernel<D> (attend<D, kPartial>, kernel 2's online body)",
         "source_d256_d512": src + " partial_kernel_wide<D> (attend_wide<D, kPartial>, kernel "
                                   "2's wide online schedule; keys split over 2-block clusters "
                                   "with the rescaling merge where partial_key_split says so)",
         "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:121 (_flash_kernel_partial) "
                     "and :384 (_flash_kernel_partial_bias), via flash_attention_partial :766",
         "launches": sharded["launches"]["flash_attention_partial"],
         "occupancy_d128": occ["kernel3_partial_d128"],
         "occupancy_d512": occ["kernel3_partial_d512"],
         "vs_library": dit["kernel3_vs_library"],
         "sharded_render_warm": {k: sharded["warm"][k] for k in ("median_s", "q1_s", "q3_s",
                                                                  "median_step_ms")},
         "ms": dit["kernel3_ms"], "plain_ms": dit["kernel3_plain_ms"],
         "bound_ms": dit["kernel3_bound_ms"], "bound_by": dit["kernel3_bound_by"],
         "library_ms": dit["library_lse_ms"],
         "library": "torch.ops.aten._scaled_dot_product_flash_attention (output + logsumexp)",
         "flagship": {k: flag[k] for k in ("kernel3_ms", "kernel3_bound_ms", "library_lse_ms",
                                           "kernel3_plain_ms_2_heads", "kernel2_ms",
                                           "kernel3_vs_library")},
         "wide_d256_d512": {
             "by_shape": wide("kernel3_ms", "kernel3_split_ms", "kernel3_unsplit_ms",
                              "kernel3_key_split", "kernel2_ms", "kernel3_bound_ms",
                              "kernel3_bound_by", "kernel3_plain_ms", "kernel3_plain_ms_1_row",
                              "library_lse_ms", "library_lse_note", "kernel3_vs_library"),
             "key_split_phase_14": {c["case"]: c["key_split"]["kernel3"] for c in var["cases"]
                                    if c["shape"][-1] > 128},
             "ring_merge_d512": var["ring_merge_d512"],
             "earlier": "PERF.md section 6 (the times of the mma.sync body this replaced)"}},
        {"name": "flash_attention_bounded_pipe", **common,
         "source": src + " bounded_kernel<D, kBoundedPipe> (D = 64, 128)",
         "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:262 (_flash_kernel_bounded_pipe)",
         "launches": var["bounded_forward"]["kernel6_launches"],
         "launches_path": "dit_forward(attn_backend=flash_attention(bounded=True, pipelined=True))",
         "ms": dit["kernel6_ms"], "plain_ms": dit["bounded_plain_ms"],
         "bound_ms": dit["bounded_bound_ms"], "bound_by": dit["bounded_bound_by"],
         "library_ms": dit["library_ms"], "library": "F.scaled_dot_product_attention bf16",
         "row_bound_prepass_ms": dit["row_bound_ms"],
         "flagship": {k: flag[k] for k in ("kernel6_ms", "bounded_bound_ms", "library_ms",
                                           "bounded_plain_ms_2_heads", "row_bound_ms")},
         "wide_d256_d512": bounded_wide("kernel6"),
         "occupancy_d128": occ["kernel6_bounded_pipe_d128"],
         "occupancy_d512": occ["kernel6_bounded_pipe_d512"], "main_path_shapes": kernel6_shapes},
        {"name": "flash_attention_bounded", **common,
         "source": src + " bounded_kernel<D, kBounded> (D = 64, 128)",
         "replaces": "diffusionrenderer_tpu/ops/flash_attention.py:130 (_flash_kernel_bounded)",
         "launches": var["bounded_forward"]["kernel7_launches"],
         "launches_path": "dit_forward(attn_backend=flash_attention_bounded_shift)",
         "ms": dit["kernel7_ms"], "plain_ms": dit["bounded_plain_ms"],
         "bound_ms": dit["bounded_bound_ms"], "bound_by": dit["bounded_bound_by"],
         "library_ms": dit["library_ms"], "library": "F.scaled_dot_product_attention bf16",
         "row_bound_prepass_ms": dit["row_bound_ms"],
         "flagship": {k: flag[k] for k in ("kernel7_ms", "bounded_bound_ms", "library_ms",
                                           "bounded_plain_ms_2_heads", "row_bound_ms")},
         "wide_d256_d512": bounded_wide("kernel7"),
         "occupancy_d128": occ["kernel7_bounded_d128"],
         "occupancy_d512": occ["kernel7_bounded_d512"]},
    ]


# ---------------------------------------------------------------------------
# Kernel 5 at head dims 256 and 512, the envmap and the forward render
# ---------------------------------------------------------------------------

# Kernel 5 at the wide head dims: the VAE's single-head attention shapes, a
# ragged D = 512 length, and D = 256 at 8 heads.
WIDE_INT8_CASES = (("vae_encode_d512", VAE_ENC_SHAPE, False),
                   ("vae_decode_d512", VAE_DEC_SHAPE, False),
                   ("ragged_d512", (2, 1000, 777, 1, 512), False), ("d256", D256_SHAPE, True))
# The forward job of the main path: 512 x 512, one frame.
FWD_RES = 512
# Card vs CPU envmap outputs, in [0, 1]: within one bf16 ulp at 1.0 (2^-8),
# the rounding the env conditions take anyway when they enter the bf16 VAE.
# Bilinear sampling is continuous in its coordinates, so the ulps by which
# the card's sin, atan2 and arccos differ from the CPU's move the outputs by
# their local gradient times ~1e-4 of a texel.
ENV_TOL = 2.0 ** -8


def wide_int8_phase():
    """Kernel 5 at D = 512 and 256 vs its plain version at the kernel's own
    key tile (64 keys) and vs exact attention
    (within 10% of the JAX tiling's error), qk8 and qk8+pv8; the
    attention(backend='pallas_pv_int8') path at each head dim, its launches
    counted from 0; timings beside SDPA, kernel 1 and the bound."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops.attention import attention

    max_err, cases = {256: 0.0, 512: 0.0}, []
    for i, (name, shape, normed) in enumerate(WIDE_INT8_CASES):
        for pv8 in (False, True):
            err, rec = fa8_case(name, shape, pv8, seed=70 + 2 * i + pv8, rms_normed=normed)
            max_err[shape[4]] = max(max_err[shape[4]], err)
            cases.append(rec)
    path_launches, timings = {}, {}
    for label, shape, normed, reps in (("vae_encode_d512", VAE_ENC_SHAPE, False, 10),
                                       ("vae_decode_d512", VAE_DEC_SHAPE, False, 5),
                                       ("d256", D256_SHAPE, True, 10)):
        d = shape[4]
        if label != "vae_encode_d512":  # the path, counted from 0 at each head dim
            q, k, v = make_qkv(shape, rms_normed=normed, seed=80)
            fa.reset_counts()
            out = attention(q, k, v, backend="pallas_pv_int8")
            torch.cuda.synchronize()
            launches = dict(fa.LAUNCHES)
            path_launches[d] = launches["flash_attention_int8"]
            err, rel, ok = compare(out, fa.flash_attention_int8_plain(
                q, k, v, pv_int8=True, block_k=fa.INT8_BLOCK_K[d]))
            say(f"  attention(backend='pallas_pv_int8') {shape}: launches {launches}, "
                f"max_abs_err {err:.3e}, rel_l2 {rel:.3e}")
            check(launches == {"flash_attention": 0, "flash_attention_headroom": 0,
                               "flash_attention_int8": 1},
                  f"pallas_pv_int8 at D={d}: launches {launches}, expected one of kernel 5")
            check(ok and bool(torch.isfinite(out).all()),
                  f"pallas_pv_int8 at D={d}: disagrees with the plain version")
            del q, k, v, out
        timings[label] = fa8_timings(label, shape, rms_normed=normed, reps=reps, seed=80)
    return {"max_err": max_err, "cases": cases, "path_launches": path_launches,
            "timings": timings}


def wide_int8_records(wide, occ):
    """Row 5 at D = 512 (the VAE decode shape) and D = 256, int8 QK^T + PV."""
    recs = []
    for d, label, others in ((512, "vae_decode_d512", ("vae_encode_d512",)), (256, "d256", ())):
        t = wide["timings"][label]
        recs.append({
            "name": f"flash_attention_int8_d{d}", "route": "cuda",
            "source": "diffusionrenderer_tpu_torch/csrc/flash_attention_int8.cu "
                      f"flash_int8_wgmma_kernel<{d}, pv8>"
                      + (" (two warpgroups, each the whole 512-deep int8 QK^T)" if d == 512
                         else ""),
            "replaces": f"diffusionrenderer_tpu/ops/flash_attention.py:317 (_flash_kernel_int8) "
                        f"at head dim {d}",
            "launches": wide["path_launches"][d],
            "launches_path": "attention(backend='pallas_pv_int8'), one call; 0 per "
                             "inverse_render or forward_render",
            "max_abs_err": wide["max_err"][d], "ms": t["pv8_ms"], "plain_ms": t["pv8_plain_ms"],
            "bound_ms": t["pv8_bound_ms"], "bound_by": t["pv8_bound_by"],
            "library_ms": t["library_ms"], "library": "F.scaled_dot_product_attention bf16",
            "shape": t["shape"], "prepass_ms": t["pv8_prepass_ms"],
            "occupancy": {k: v for k, v in occ.items() if k.startswith(f"kernel5_d{d}")},
            "timings": {k: wide["timings"][k] for k in (label, *others)}})
    return recs


def synthetic_panorama(seed: int, h: int = 1024, w: int = 2048):
    """An HDR sky from a seeded generator: a smooth gradient of ~0.2 to ~4,
    a sun of ~1e3 and 5% multiplicative texel noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, np.pi, h), np.linspace(0, 2 * np.pi, w), indexing="ij")
    phase = rng.uniform(0, 2 * np.pi, 3)
    sky = 0.2 + 2.0 * np.sin(yy)[..., None] * (1.0 + 0.8 * np.cos(xx[..., None] + phase))
    sun = 1000.0 * np.exp(-((yy - 0.7) ** 2 + (xx - rng.uniform(1, 5)) ** 2) / 0.002)
    pano = (sky + sun[..., None]) * rng.uniform(0.95, 1.05, (h, w, 3))
    return pano.astype(np.float32)


def load_batch_case(out_dir: str, n: int = 8):
    """n seeded 1024 x 2048 panoramas as .hdr files through io.load_batch
    (the codec's thread pool, 4 threads) against n serial io.native_read
    calls: bitwise equal; both walls."""
    import numpy as np
    from diffusionrenderer_tpu_torch import io as tio

    paths = []
    for i in range(n):
        paths.append(os.path.join(out_dir, f"frame{i}.hdr"))
        tio.save_hdr(paths[-1], synthetic_panorama(200 + i))
    t0 = time.perf_counter()
    serial = [tio.native_read(p_) for p_ in paths]
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = tio.load_batch(paths, num_threads=4)
    batch_s = time.perf_counter() - t0
    for p_ in paths:
        os.remove(p_)
    rec = {"files": n, "shape": list(batch[0].shape), "threads": 4,
           "bitwise_equal": all(np.array_equal(a, b) for a, b in zip(batch, serial)),
           "load_batch_s": batch_s, "serial_native_read_s": serial_s}
    say("  load_batch " + json.dumps(rec))
    check(len(batch) == n and rec["bitwise_equal"],
          "io.load_batch differs from serial native_read calls")
    return rec


def envmap_phase():
    """A synthetic 1024 x 2048 panorama through the port's .hdr codec and
    load_hdr (held to RGBE precision), then the projections at 512 x 512
    (cubemap, direct) and the ball tone map on the card against the same
    functions on the CPU, with a few NaN / inf texels.  Returns (the .hdr
    path, record)."""
    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch import envmap, load_hdr
    from diffusionrenderer_tpu_torch import io as tio

    pano = synthetic_panorama(61)
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "panorama.hdr")
    tio.save_hdr(path, pano)
    env = load_hdr(path)
    bound = pano.max(axis=-1, keepdims=True) / 128.0 + 1e-6
    rec = {"panorama": list(pano.shape), "max": float(pano.max()),
           "roundtrip_max_abs_err": float(np.abs(env[0] - pano).max()),
           "roundtrip_within_rgbe": bool(np.all(np.abs(env[0] - pano) <= bound)),
           "load_hdr_is_native": bool(np.array_equal(env[0], tio.native_read(path)))}
    check(env.shape == (1, *pano.shape) and rec["roundtrip_within_rgbe"],
          "load_hdr: the .hdr round trip is outside RGBE precision")
    check(rec["load_hdr_is_native"], "load_hdr did not read through the native codec")
    rec["load_batch"] = load_batch_case(out_dir)
    src = env[0].copy()
    src[5, 7] = np.nan
    src[100, 200] = np.inf
    src[300, 1000, 1] = -np.inf
    res = (FWD_RES, FWD_RES)
    runs = {
        "proj_cubemap": lambda dev: envmap.render_projection_from_panorama(
            src, res, env_flip=True, env_rot=90.0, use_cache=False, mode="cubemap", device=dev),
        "proj_direct": lambda dev: envmap.render_projection_from_panorama(
            src, res, env_flip=True, env_rot=90.0, use_cache=False, mode="direct", device=dev),
        "ball": lambda dev: envmap.tonemap_image_direct(src, res, use_cache=False, device=dev),
    }
    for name, run in runs.items():
        got, want = run("cuda"), run("cpu")
        r = {"ms": time_ms(lambda: run("cuda"), reps=5), "tol": ENV_TOL}
        for key in ("env_ldr", "env_log"):
            g, w = got[key], want[key]
            check(tuple(g.shape) == (1, *res, 3) and g.is_cuda, f"{name} {key}: shape / device")
            diff = (g.cpu() - w).abs()
            r[f"{key}_max_abs_err"] = diff.max().item()
            r[f"{key}_mean_abs_err"] = diff.mean().item()
            check(bool(torch.isfinite(g).all()) and 0.0 <= g.min().item() and g.max().item() <= 1.0,
                  f"{name} {key}: not finite in [0, 1]")
            check(r[f"{key}_max_abs_err"] <= ENV_TOL, f"{name} {key}: card disagrees with CPU")
        rec[name] = r
    say("envmap " + json.dumps(rec))
    return path, rec


def forward_gbuffers(frames: int, seed: int):
    """Seeded uint8 G-buffers in forward_render's argument order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (1, frames, FWD_RES, FWD_RES, 3) if frames > 1 else (1, FWD_RES, FWD_RES, 3)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(5)]


def forward_call(pipe, gbuf, env, frames: int, expected: int, label: str):
    """One forward_render with the counts set to 0 just before it and read
    just after; checks the output and the launches."""
    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch import forward_render
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    t0 = time.perf_counter()
    out = forward_render(pipe, *gbuf, env, env_format="proj")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES}
    branches = fa.branch_counts("cuda")
    rec = {"call": label, "frames": frames, "wall_s": wall,
           **{f"{k}_s": v for k, v in pipe.timings.items()},
           "denoise_step_s": pipe.timings["denoise"] / pipe.num_steps,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "expected_launches": expected, "branches": branches}
    say(f"forward_{label} " + json.dumps(rec))
    check(out.shape == (frames, FWD_RES, FWD_RES, 3), f"forward {label}: shape {out.shape}")
    check(bool(np.isfinite(out).all()) and out.min() >= 0.0 and out.max() <= 1.0,
          f"forward {label}: values not finite in [0, 1]")
    # One headroom and one attention launch (kernels 1 and 2) per call.
    for name in ("flash_attention", "flash_attention_headroom"):
        check(launches[name] == expected,
              f"forward {label}: {name} {launches[name]} launches, expected {expected}")
    check(sum(v for k, v in launches.items() if k not in (
        "flash_attention", "flash_attention_headroom")) == 0,
          f"forward {label}: other kernels launched {launches}")
    check(branches["noshift"] + branches["online"] == expected,
          f"forward {label}: branch counts do not add up")
    return rec


def forward_path_phase(env_path: str):
    """The slice's main path: load_pipeline(model_type='forward') at the full
    FADITV2_7B width, load_hdr, then forward_render of seeded uint8 G-buffers
    at 512 x 512, one frame, 15 steps, guidance 0, env_format='proj' (first
    call and warm call), and a 9-frame job.  Returns (pipe, record)."""
    import torch
    from diffusionrenderer_tpu_torch import load_hdr, load_pipeline
    from diffusionrenderer_tpu_torch.config import get_forward_renderer_config

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pipe = load_pipeline(model_type="forward")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = get_forward_renderer_config(FWD_RES, FWD_RES, 1)
    net = cfg.net
    rec = {"load_s": load_s, "load_peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "weights_gib": torch.cuda.memory_allocated() / 2 ** 30,
           "net": {"model_channels": net.model_channels, "num_blocks": net.num_blocks,
                   "num_heads": net.num_heads, "patch_dim": net.patch_dim,
                   "additional_concat_ch": net.additional_concat_ch}}
    check(pipe.dit_params["x_embedder"]["weight"].shape[1] == net.patch_dim == 612,
          "forward DiT: patch_dim is not 612")
    t0 = time.perf_counter()
    env = load_hdr(env_path)
    rec["load_hdr_s"] = time.perf_counter() - t0
    # One attention call per DiT block per step (guidance 0), plus the VAE
    # mid-block's spatial attention in each of the 8 condition encodes and
    # in the one decode.
    expected = pipe.num_steps * net.num_blocks + len(cfg.condition_keys) + 1
    gbuf = forward_gbuffers(1, seed=62)
    rec["first"] = forward_call(pipe, gbuf, env, 1, expected, "first")
    rec["warm"] = forward_call(pipe, gbuf, env, 1, expected, "warm")
    # Four more warm calls, not counted: the warm call's spread.
    from diffusionrenderer_tpu_torch import forward_render

    more = warm_calls(lambda: forward_render(pipe, *gbuf, env, env_format="proj"), 4, pipe)
    walls = [rec["warm"]["wall_s"], *more["wall_s"]]
    steps = [rec["warm"]["denoise_step_s"] * 1e3, *more["step_ms"]]
    rec["warm_5"] = {"wall_s": walls, "step_ms": steps, **dict(zip(
        ("q1_s", "median_s", "q3_s"), statistics.quantiles(walls, n=4, method="inclusive"))),
        "median_step_ms": statistics.median(steps)}
    say("forward_warm_5 " + json.dumps(rec["warm_5"]))
    rec["frames_9"] = forward_call(pipe, forward_gbuffers(9, seed=63), env, 9, expected,
                                   "9_frames")
    say("main_path_forward " + json.dumps({k: v for k, v in rec.items()
                                           if k not in ("first", "warm", "frames_9")}))
    return pipe, rec


def forward_dit_inputs(net, seed: int):
    """Seeded bf16 inputs of one forward DiT step at the main path's shape:
    one 512 x 512 frame's 64 x 64 latent, 136 condition channels."""
    import torch

    g = torch.Generator("cuda").manual_seed(seed)
    lat = FWD_RES // 8
    x = torch.randn(1, 1, lat, lat, 16, generator=g, device="cuda").bfloat16()
    cond = torch.randn(1, 1, lat, lat, net.additional_concat_ch, generator=g,
                       device="cuda").bfloat16()
    return x, torch.full((1,), 2.5, device="cuda"), cond, torch.zeros(1, dtype=torch.long,
                                                                      device="cuda")


def forward_reference_phase(pipe):
    """One forward DiT step at the main path's shape through the kernels vs
    the plain attention path; then its profile."""
    import torch
    from diffusionrenderer_tpu_torch.config import get_forward_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    net = get_forward_renderer_config(FWD_RES, FWD_RES, 1).net
    x, sigma, cond, ctx = forward_dit_inputs(net, 64)
    with torch.no_grad():
        fa.reset_counts()
        got = dit_forward(pipe.dit_params, x, sigma, cond, ctx, net)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        want = dit_forward(pipe.dit_params, x, sigma, cond, ctx, net, attn_backend="xla")
    rec = {"dit_rel_err": rel_l2(got, want), "launches": launches,
           "finite": bool(torch.isfinite(got).all())}
    say("forward_reference " + json.dumps(rec))
    check(launches == net.num_blocks, f"forward DiT step: {launches} kernel launches")
    check(rec["finite"] and rec["dit_rel_err"] <= 2e-2,
          "forward DiT step: kernel path disagrees with the plain path")
    rec["profile"] = profile_phase(pipe.dit_params, "forward", net=net,
                                   inputs=forward_dit_inputs(net, 65))
    return rec


# ---------------------------------------------------------------------------
# Real checkpoints, long video and guidance
# ---------------------------------------------------------------------------

# Phase 24's checkpoints go here (build/ is not committed); main() removes
# them after phase 28, the last to read them.
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_checkpoints")
# The long-video job: 57 frames at 704 x 1280, 8 latent frames, decoded in
# chunks of 4 latents (3 chunks: 25 + 24 + 8 frames).
LONG_VIDEO = (1, 57, 704, 1280, 3)
LONG_VIDEO_CHUNK = 4
GIB = 2 ** 30


def _flat_equal(got, want) -> int:
    """Assert two parameter trees hold the same leaves bit for bit; the
    number of leaves compared."""
    import torch
    from diffusionrenderer_tpu_torch.checkpoint import _flatten

    a, b = _flatten(got), _flatten(want)
    check(sorted(a) == sorted(b), f"trees differ in keys: {sorted(set(a) ^ set(b))[:5]}")
    for k, v in a.items():
        check(v.dtype == b[k].dtype and v.shape == b[k].shape and torch.equal(v, b[k]),
              f"leaf {k} differs")
    return len(a)


def checkpoint_phase():
    """Write the seeded full-width DiT as a reference-format .safetensors
    file and the CV8x8x8 VAE as a diffusers directory, load both through
    load_pipeline (bf16, then quantized on load), hold every parameter
    bitwise against the in-memory weights, and round-trip the W8A8 tree
    through the native format.  Returns the bf16 pipeline and the record,
    whose dit_path and vae_dir name the reference files (left on disk for
    the surface phases)."""
    import shutil

    import torch
    from diffusionrenderer_tpu_torch.api import load_pipeline
    from diffusionrenderer_tpu_torch.checkpoint import (export_dit_state_dict, restore_native,
                                                        save_native)
    from diffusionrenderer_tpu_torch.checkpoint_vae import (bundled_latent_stats,
                                                            export_diffusers_vae_state_dict)
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward, dit_param_count, init_dit_params
    from diffusionrenderer_tpu_torch.models.quant import quantize_dit_params
    from diffusionrenderer_tpu_torch.models.vae import init_vae_params
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm
    from diffusionrenderer_tpu_torch.utils.safetensors import write_safetensors

    cfg = get_inverse_renderer_config(512, 512, 1)
    net, vae = cfg.net, cfg.vae
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    df = subprocess.run(["df", "-h", CKPT_DIR], capture_output=True, text=True,
                        timeout=60).stdout.strip()
    say("  " + df.replace("\n", "\n  "))
    free = shutil.disk_usage(CKPT_DIR).free
    # The bf16 file, the W8A8 native file beside it (about 1 byte a
    # parameter), the VAE and a margin.
    need = dit_param_count(net) * 3 + GIB
    rec = {"disk_free_gib": free / GIB, "dit_file_need_gib": need / GIB,
           "blocks": net.num_blocks}
    check(free >= need, f"the disk holds {free / GIB:.1f} GiB, the checkpoint needs "
                        f"{need / GIB:.1f} GiB")
    dit_path = os.path.join(CKPT_DIR, "dit.safetensors")
    vae_dir = os.path.join(CKPT_DIR, "vae")
    native_path = os.path.join(CKPT_DIR, "dit_w8a8_native.safetensors")
    try:
        params = init_dit_params(net, device="cuda", dtype=torch.bfloat16, seed=0)
        vparams = init_vae_params(vae, device="cuda", dtype=torch.bfloat16, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write_safetensors(dit_path, export_dit_state_dict(params, net))
        rec["dit_write_s"] = time.perf_counter() - t0
        rec["dit_file_gib"] = os.path.getsize(dit_path) / GIB
        t0 = time.perf_counter()
        os.makedirs(vae_dir)
        write_safetensors(os.path.join(vae_dir, "diffusion_pytorch_model.safetensors"),
                          export_diffusers_vae_state_dict(vparams, vae))
        stats = bundled_latent_stats()
        with open(os.path.join(vae_dir, "config.json"), "w") as f:
            json.dump({"_class_name": "AutoencoderKLCosmos", **stats}, f)
        rec["vae_write_s"] = time.perf_counter() - t0
        rec["vae_file_gib"] = os.path.getsize(
            os.path.join(vae_dir, "diffusion_pytorch_model.safetensors")) / GIB

        # The bf16 load: every parameter bitwise the in-memory weights, the
        # device peak within the weights plus 1 GiB.
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipe = load_pipeline(dit_checkpoint=dit_path, vae_checkpoint=vae_dir)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
        rec["load_weights_gib"] = (torch.cuda.memory_allocated() - base) / GIB
        rec["load_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / GIB
        rec["load_gib_per_s"] = (rec["dit_file_gib"] + rec["vae_file_gib"]) / rec["load_s"]
        rec["dit_leaves_bitwise"] = _flat_equal(pipe.dit_params, params)
        want_vae = dict(vparams)
        for key in ("latents_mean", "latents_std"):
            want_vae[key] = torch.tensor(stats[key], dtype=torch.float32,
                                         device="cuda").reshape(vae.latent_channels,
                                                                vae.max_latent_frames)
        rec["vae_leaves_bitwise"] = _flat_equal(pipe.vae_params, want_vae)
        check(rec["load_peak_gib"] <= rec["load_weights_gib"] + 1.0,
              f"load peak {rec['load_peak_gib']:.2f} GiB exceeds the weights "
              f"{rec['load_weights_gib']:.2f} GiB + 1 GiB")
        del vparams, want_vae

        # Quantized on load (W8A8, per channel): the codes and scales of
        # quantize_dit_params of the in-memory weights, and the same W8A8
        # forward bit for bit.
        want = quantize_dit_params(params, act_quant=True)
        del params
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        qpipe = load_pipeline(dit_checkpoint=dit_path, vae_checkpoint=vae_dir,
                              quantize_int8=True, act_quant=True)
        torch.cuda.synchronize()
        rec["w8a8_load_s"] = time.perf_counter() - t0
        rec["w8a8_load_weights_gib"] = (torch.cuda.memory_allocated() - base) / GIB
        rec["w8a8_load_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / GIB
        rec["w8a8_leaves_bitwise"] = _flat_equal(qpipe.dit_params, want)
        x, sigma, cond, ctx = dit_inputs(24)
        with torch.no_grad():
            qm.reset_counts()
            got = dit_forward(qpipe.dit_params, x, sigma, cond, ctx, net)
            torch.cuda.synchronize()
            rec["w8a8_forward_launches"] = qm.LAUNCHES["quant_matmul_w8a8"]
            ref = dit_forward(want, x, sigma, cond, ctx, net)
        rec["w8a8_forward_bitwise"] = bool(torch.equal(got, ref))
        check(rec["w8a8_forward_bitwise"], "W8A8 forward from the loaded codes differs")
        check(rec["w8a8_forward_launches"] == 6 * net.num_blocks,
              f"W8A8 forward: {rec['w8a8_forward_launches']} kernel-4 launches, "
              f"expected {6 * net.num_blocks}")
        del want, got, ref

        # The port's native format: the W8A8 tree round-trips bit for bit.
        t0 = time.perf_counter()
        save_native(native_path, qpipe.dit_params)
        rec["native_save_s"] = time.perf_counter() - t0
        rec["native_file_gib"] = os.path.getsize(native_path) / GIB
        t0 = time.perf_counter()
        back = restore_native(native_path)
        torch.cuda.synchronize()
        rec["native_restore_s"] = time.perf_counter() - t0
        rec["native_leaves_bitwise"] = _flat_equal(back, qpipe.dit_params)
        del back, qpipe
        os.remove(native_path)
        torch.cuda.empty_cache()
    except BaseException:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        raise
    say("checkpoints " + json.dumps(rec))
    # The reference files stay for phases 27 and 28; main() removes them.
    rec["dit_path"], rec["vae_dir"] = dit_path, vae_dir
    return pipe, rec


# Phase 25's render peak and ms per DiT step as measured before the
# pipeline chunked the MLP (PERF.md section 5, on the same card model).
UNCHUNKED_LONG_VIDEO = {"render_peak_gib": 18.18, "ms_per_dit_step": 1418.1}


def long_video_phase(pipe):
    """inverse_render of a seeded 57-frame 704x1280 clip (one pass) from the
    checkpoint-loaded bf16 pipeline, decoded in chunks of 4 latents: the
    outputs, the first chunk bitwise against an unchunked decode of latents
    0-3 of the same sample, every attention launch, the phase times, and the
    decoder's peak chunked and unchunked."""
    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch.api import inverse_render
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.pipeline import decode

    b, t, h, w, c = LONG_VIDEO
    clip = np.random.default_rng(25).integers(0, 256, LONG_VIDEO, dtype=np.uint8)
    captured = {}
    overlapped = pipe._decode_overlapped

    def capture(sample, normal_mask, cfg, chunk, overlap=1):
        out = overlapped(sample, normal_mask, cfg, chunk, overlap)
        captured.update(sample=sample, mask=normal_mask, cfg=cfg, u8=out)
        return out

    pipe.decode_chunk_frames = LONG_VIDEO_CHUNK
    pipe._decode_overlapped = capture
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_counts()
        t0 = time.perf_counter()
        out = inverse_render(pipe, clip, passes=("basecolor",))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        branches = fa.branch_counts("cuda")
    finally:
        del pipe._decode_overlapped
        pipe.decode_chunk_frames = None
    net = captured["cfg"].net
    t_lat = captured["sample"].shape[1]
    chunks = len(range(0, t_lat - 1, LONG_VIDEO_CHUNK - 1))
    tokens = t_lat * (h // 16) * (w // 16)
    rec = {"shape": list(LONG_VIDEO), "latent_frames": t_lat, "tokens": tokens,
           "decode_chunk_frames": LONG_VIDEO_CHUNK, "decode_chunks": chunks, "wall_s": wall,
           "encode_s": pipe.timings["encode"], "denoise_s": pipe.timings["denoise"],
           "decode_s": pipe.timings["decode"],
           "ms_per_dit_step": pipe.timings["denoise"] / pipe.num_steps * 1e3,
           "render_peak_gib": torch.cuda.max_memory_allocated() / GIB,
           "render_peak_reserved_gib": torch.cuda.max_memory_reserved() / GIB,
           "graph_pool_gib": graph_pool_gib(
               list(pipe._step_graphs._graphs.values())[-1].graph),
           "launches": launches, "branches": branches}
    basecolor = out["basecolor"]
    check(basecolor.shape == (t, h, w, c), f"long video output shape {basecolor.shape}")
    check(bool(np.isfinite(basecolor).all()) and basecolor.min() >= 0.0
          and basecolor.max() <= 1.0, "long video output not finite in [0, 1]")
    expected = pipe.num_steps * net.num_blocks + 1 + chunks
    rec["expected_launches"] = expected
    for name in ("flash_attention", "flash_attention_headroom"):
        check(launches[name] == expected,
              f"long video {name}: {launches[name]} launches, expected {expected}")

    # The first chunk against one unchunked decode of the same latents, and
    # the decoder's peak chunked (the whole overlapped decode) and
    # unchunked (all latents at once).
    sample, mask, cfg = captured["sample"], captured["mask"], captured["cfg"]
    with torch.no_grad():
        first = decode(pipe.vae_params, sample[:, :LONG_VIDEO_CHUNK], mask, cfg=cfg).cpu().numpy()
        frames = first.shape[1]
        rec["first_chunk_frames"] = frames
        rec["first_chunk_bitwise"] = bool(np.array_equal(captured["u8"][:, :frames], first))
        check(rec["first_chunk_bitwise"], "the first decode chunk differs from the "
                                          "unchunked decode of its latents")
        del first
        for label, run in (("chunked", lambda: pipe._decode_overlapped(
                                sample, mask, cfg, LONG_VIDEO_CHUNK)),
                           ("unchunked", lambda: decode(pipe.vae_params, sample, mask,
                                                        cfg=cfg).cpu().numpy())):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            u8 = run()
            torch.cuda.synchronize()
            rec[f"decode_{label}_s"] = time.perf_counter() - t0
            rec[f"decode_{label}_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / GIB
            rec[f"decode_{label}_frames"] = u8.shape[1]
            del u8
    rec.update(long_video_mlp_chunks(pipe, cfg, sample))
    say("long_video " + json.dumps(rec))
    say(f"  long video: mlp_token_chunks resolved to {rec['mlp_token_chunks']} at {tokens} "
        f"tokens; render peak {rec['render_peak_gib']:.2f} GiB allocated, "
        f"{rec['render_peak_reserved_gib']:.2f} reserved, the step graph's pool "
        f"{rec['graph_pool_gib']:.2f} (unchunked MLP: "
        f"{UNCHUNKED_LONG_VIDEO['render_peak_gib']} GiB), {rec['ms_per_dit_step']:.1f} ms per "
        f"DiT step (unchunked MLP: {UNCHUNKED_LONG_VIDEO['ms_per_dit_step']} ms)")
    return rec


def long_video_mlp_chunks(pipe, cfg, sample):
    """The pipeline's MLP token chunks at the long video's 28,160 tokens
    (the JAX package's auto rule: 4), and one DiT forward at that shape
    with the resolved chunks against one with none: their device peaks,
    times and relative L2 (cuBLAS may pick another algorithm for a chunk's
    7,040 rows, so bitwise equality is not expected)."""
    import torch
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.pipeline import resolve_mlp_token_chunks

    chunks = resolve_mlp_token_chunks(cfg, pipe.mlp_token_chunks)
    check(chunks == 4, f"mlp_token_chunks resolved to {chunks} at the long video, expected 4")
    net = cfg.net
    g = torch.Generator("cuda").manual_seed(251)
    x = sample.to(torch.bfloat16)
    cond = torch.randn(*x.shape[:4], net.additional_concat_ch, generator=g,
                       device="cuda").bfloat16()
    sigma, ctx = torch.full((1,), 2.5, device="cuda"), torch.zeros(1, device="cuda")
    rec = {"mlp_token_chunks": chunks}
    outs = {}
    with torch.no_grad():
        for n in (chunks, 1):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs[n] = dit_forward(pipe.dit_params, x, sigma, cond, ctx, net, mlp_token_chunks=n)
            torch.cuda.synchronize()
            rec[f"forward_mlp_chunks_{n}_s"] = time.perf_counter() - t0
            rec[f"forward_mlp_chunks_{n}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                                       - base) / GIB
    rec["forward_chunked_vs_unchunked_rel_l2"] = rel_l2(outs[chunks], outs[1])
    rec["forward_chunked_bitwise"] = bool(torch.equal(outs[chunks], outs[1]))
    # Phase 8's bound for bf16 noise through 28 blocks.
    check(rec["forward_chunked_vs_unchunked_rel_l2"] <= 3e-2,
          "the chunked MLP moves the long video's DiT forward")
    return rec


def guidance_phase(pipe, phase7_step_ms: float):
    """One pass at 512x512, 1 frame, guidance 1.0 (each DiT forward takes
    the conditional and unconditional rows), first call and 3 warm calls,
    beside the same call at guidance 0."""
    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch.api import inverse_render
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    image = np.random.default_rng(26).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    rec = {"phase7_guidance0_5_pass_step_ms": phase7_step_ms}
    for g in (1.0, 0.0):
        call = lambda: inverse_render(pipe, image, guidance=g, passes=("basecolor",))  # noqa: E731
        fa.reset_counts()
        out = call()
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        expected = pipe.num_steps * len(pipe.dit_params["blocks"]) + 2
        check(launches == expected, f"guidance {g}: {launches} attention launches, "
                                    f"expected {expected}")
        check(out["basecolor"].shape == (1, 512, 512, 3)
              and bool(np.isfinite(out["basecolor"]).all()), f"guidance {g}: bad output")
        rec[f"guidance_{g}"] = {"launches": launches, **warm_calls(call, 3, pipe)}
    say("guidance " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# The user surfaces: the CLI, the ComfyUI nodes, the batching server
# ---------------------------------------------------------------------------

SURFACE_DIR = os.path.join(ROOT, "build", "chip_smoke", "surfaces")
GBUFFER_NAMES = ("depth", "normal", "roughness", "metallic", "basecolor")
# Runs the CLI's main() in a subprocess, then prints the metrics registry
# and the kernels' launch counts of that process on its last line.
CLI_RUN = (
    "import json, sys\n"
    "from diffusionrenderer_tpu_torch.cli import main\n"
    "from diffusionrenderer_tpu_torch.ops import flash_attention as fa, quant_matmul as qm\n"
    "from diffusionrenderer_tpu_torch.utils.profiling import metrics\n"
    "main(sys.argv[1:])\n"
    "print('surface_cli ' + json.dumps({'registry': metrics.summary(),\n"
    "                                   'launches': {**fa.LAUNCHES, **qm.LAUNCHES}}))\n"
)
# A batched row of the server against the same request generated alone, at
# uint8: 5 rows may take other cuBLAS algorithms than 1, so the floor is a
# PSNR, not equality (bf16 renders of one model by two implementations
# land near 39.5 dB).
SERVER_PSNR_DB = 30.0


def _cli(label: str, args, timeout: int = 600):
    """One CLI subprocess from the checkout's root (where the kernels built
    by phase 2 are found); its wall time, and the last line's record when
    it prints one."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"CLI {label} exited {res.returncode}:\n{res.stderr[-6000:]}")
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    rec = {"wall_s": wall}
    if last.startswith("surface_cli "):
        rec.update(json.loads(last[len("surface_cli "):]))
    return rec, res.stdout


def _png_check(path: str, shape, want=None) -> None:
    """A PNG the CLI wrote: its shape and dtype, and either its pixels
    equal to `want` (a uint8 array) or, without one, not all one value."""
    import numpy as np
    from diffusionrenderer_tpu_torch import io as tio

    img = tio.read_png(path)
    check(img.shape == shape and img.dtype == np.uint8, f"{path}: {img.shape} {img.dtype}")
    if want is None:
        check(int(img.max()) > int(img.min()), f"{path}: a constant image")
    else:
        check(np.array_equal(img, want), f"{path}: differs from the in-process result")


def cli_phase(env_path: str, ckpt):
    """The CLI at full width, each command in its own process on the card
    (no --cpu, no --tiny): info; inverse of a seeded 512x512 PNG (two
    passes, 15 steps) from phase 24's reference files; forward of seeded
    PNG G-buffers under phase 20's .hdr; envmap of that panorama.  The
    outputs read back through the port's codec."""
    import shutil

    import numpy as np
    from diffusionrenderer_tpu_torch import io as tio
    from diffusionrenderer_tpu_torch.config import PRESET_NAMES, get_preset_config
    from diffusionrenderer_tpu_torch.models.dit import dit_param_count

    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    os.makedirs(SURFACE_DIR)
    rng = np.random.default_rng(27)
    pngs = {}
    for name in ("rgb", *GBUFFER_NAMES):
        pngs[name] = os.path.join(SURFACE_DIR, f"{name}.png")
        tio.write_png(pngs[name], rng.integers(0, 256, (FWD_RES, FWD_RES, 3), dtype=np.uint8))
    rec = {}
    info_rec, out = _cli("info", ["-m", "diffusionrenderer_tpu_torch.cli", "info"])
    info = json.loads(out)
    rec["info"] = {"wall_s": info_rec["wall_s"], "backend": info["backend"],
                   "devices": info["devices"]}
    import torch

    check(info["backend"] == "cuda" and info["devices"] == torch.cuda.device_count(),
          f"CLI info: {rec['info']}")
    check(sorted(info["presets"]) == sorted(PRESET_NAMES) and all(
        info["presets"][n]["params_b"] == round(dit_param_count(get_preset_config(n).net) / 1e9, 3)
        for n in PRESET_NAMES), "CLI info: presets")

    inv_dir = os.path.join(SURFACE_DIR, "inverse")
    relit = os.path.join(SURFACE_DIR, "relit.png")
    env_prefix = os.path.join(SURFACE_DIR, "env")
    gbuf_args = [a for g in GBUFFER_NAMES for a in (f"--{g}", pngs[g])]
    # One attention call per DiT block per step, plus the VAE's encode(s)
    # and decode (the 2 inverse passes share one encode and one decode; the
    # forward render encodes 8 conditions).
    blocks, steps = 28, 15
    runs = {
        "inverse": (["-c", CLI_RUN, "inverse", "--passes", "basecolor,normal",
                     "--checkpoint", ckpt["dit_path"], "--vae", ckpt["vae_dir"],
                     "--input", pngs["rgb"], "--output-dir", inv_dir], steps * blocks + 2),
        "forward": (["-c", CLI_RUN, "forward", *gbuf_args, "--env", env_path,
                     "--output", relit], steps * blocks + 9),
        "envmap": (["-c", CLI_RUN, "envmap", "--input", env_path, "--height", str(FWD_RES),
                    "--width", str(FWD_RES), "--output-prefix", env_prefix], 0),
    }
    for label, (args, expected) in runs.items():
        r, _ = _cli(label, args)
        launches = r["launches"]
        for name in ("flash_attention", "flash_attention_headroom"):
            check(launches[name] == expected,
                  f"CLI {label}: {name} {launches[name]} launches, expected {expected}")
        check(launches["quant_matmul_w8a8"] == 0, f"CLI {label}: W8A8 launches")
        rec[label] = {"wall_s": r["wall_s"], "launches": launches, "expected_launches": expected,
                      "registry": {k: v for k, v in r["registry"].items()
                                   if k.startswith(("generate/", "api/"))}}
    for name in ("basecolor", "normal"):
        _png_check(os.path.join(inv_dir, f"{name}.png"), (FWD_RES, FWD_RES, 3))
    check(sorted(os.listdir(inv_dir)) == ["basecolor.png", "normal.png"], "CLI inverse outputs")
    _png_check(relit, (FWD_RES, FWD_RES, 3))
    # The envmap PNGs against the same projection in this process: env_ldr
    # saturates wherever the panorama exceeds 1/15 (Reinhard scaled by 16,
    # as in the reference), so it may well be one value throughout.
    from diffusionrenderer_tpu_torch.envmap import render_projection_from_panorama

    env = render_projection_from_panorama(tio.load_image(env_path), resolution=(FWD_RES, FWD_RES),
                                          env_flip=False, env_rot=180.0, use_cache=False,
                                          device="cuda")  # the CLI's defaults
    for name in ("env_ldr", "env_log"):
        want = (np.clip(env[name][0].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        _png_check(f"{env_prefix}_{name}.png", (FWD_RES, FWD_RES, 3), want)
    say("surface_cli " + json.dumps(rec))
    return rec


def _unit_tensor(rng, shape):
    import numpy as np
    import torch

    return torch.from_numpy(rng.uniform(size=shape).astype(np.float32))


def nodes_phase(env_path: str, ckpt):
    """The four ComfyUI nodes at full width: the loader from phase 24's
    reference files in bf16 and in its default w8a8 (kernel 4 on every
    block matmul), the inverse renderer on a CPU float IMAGE tensor, bitwise
    api.inverse_render on the same pipeline and seed; LoadHDRImage of phase
    20's panorama into the forward renderer on a forward pipeline."""
    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch import api
    from diffusionrenderer_tpu_torch import comfy_nodes as cn
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm

    rng = np.random.default_rng(28)
    image = _unit_tensor(rng, (1, FWD_RES, FWD_RES, 3))
    blocks, steps = 28, 15
    rec = {}
    for mode in ("bf16", "w8a8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (pipe,) = cn.LoadDiffusionRendererModel().load_pipeline(
            model=ckpt["dit_path"], quant_mode=mode, vae_path=ckpt["vae_dir"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        fa.reset_counts()
        qm.reset_counts()
        t0 = time.perf_counter()
        outs = cn.Cosmos1InverseRenderer().run_inverse_pass(pipe, image, guidance=0.0, seed=28)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**fa.LAUNCHES, **qm.LAUNCHES}
        ref = api.inverse_render(pipe, image.numpy(), guidance=0.0, seed=28)
        bitwise = all(np.array_equal(t.numpy(), ref["basecolor" if n == "base_color" else n])
                      for n, t in zip(cn.Cosmos1InverseRenderer.RETURN_NAMES, outs))
        expected = steps * blocks + 2
        expected_qmm = 6 * blocks * steps if mode == "w8a8" else 0
        rec[f"inverse_{mode}"] = {"load_s": load_s, "wall_s": wall, "launches": launches,
                                  "expected_launches": expected,
                                  "expected_w8a8_launches": expected_qmm,
                                  "bitwise_api": bitwise}
        check(len(outs) == 5, f"inverse node {mode}: {len(outs)} outputs")
        for t in outs:
            v = t.numpy()
            check(t.shape == (1, FWD_RES, FWD_RES, 3) and t.dtype == torch.float32,
                  f"inverse node {mode}: {tuple(t.shape)} {t.dtype}")
            check(bool(np.isfinite(v).all()) and v.min() >= 0.0 and v.max() <= 1.0,
                  f"inverse node {mode}: values not finite in [0, 1]")
        check(bitwise, f"inverse node {mode}: differs from api.inverse_render")
        for name in ("flash_attention", "flash_attention_headroom"):
            check(launches[name] == expected,
                  f"inverse node {mode}: {name} {launches[name]} launches, expected {expected}")
        check(launches["quant_matmul_w8a8"] == expected_qmm,
              f"inverse node {mode}: {launches['quant_matmul_w8a8']} W8A8 launches, "
              f"expected {expected_qmm}")
        del pipe, outs, ref
        torch.cuda.empty_cache()

    pipe = api.load_pipeline(model_type="forward")
    (env,) = cn.LoadHDRImage().load_hdr(env_path)
    check(tuple(env.shape) == (1, 1024, 2048, 3) and float(env.max()) > 1.0,
          f"LoadHDRImage: {tuple(env.shape)}, max {float(env.max())}")
    gbuf = {g: _unit_tensor(rng, (1, FWD_RES, FWD_RES, 3))
            for g in ("depth", "normal", "roughness", "metallic", "base_color")}
    fa.reset_counts()
    t0 = time.perf_counter()
    (out,) = cn.Cosmos1ForwardRenderer().run_forward_pass(pipe, env_map=env, seed=28, **gbuf)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expected = steps * blocks + 9
    launches = dict(fa.LAUNCHES)
    rec["forward"] = {"wall_s": wall, "launches": launches, "expected_launches": expected}
    v = out.numpy()
    check(tuple(out.shape) == (1, FWD_RES, FWD_RES, 3) and bool(np.isfinite(v).all())
          and v.min() >= 0.0 and v.max() <= 1.0, "forward node: bad output")
    for name in ("flash_attention", "flash_attention_headroom"):
        check(launches[name] == expected,
              f"forward node: {name} {launches[name]} launches, expected {expected}")
    del pipe
    torch.cuda.empty_cache()
    say("surface_nodes " + json.dumps(rec))
    return rec


def server_phase():
    """ServingExecutor(max_batch=5) over a bf16 inverse pipeline at 512x512:
    five requests (context_index 0-4, seeds 0-4) from five threads go out as
    one dispatch of 5 rows, bitwise a direct 5-row generate of the same
    rows and within SERVER_PSNR_DB of each request generated alone; then a
    trickle of two shape buckets, and shutdown(drain=True) with requests
    pending."""
    import threading

    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch import load_pipeline
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.serving import ServingExecutor
    from diffusionrenderer_tpu_torch.utils.metrics import psnr
    from diffusionrenderer_tpu_torch.utils.profiling import metrics

    pipe = load_pipeline()
    rng = np.random.default_rng(29)
    image = rng.integers(0, 256, (1, 1, FWD_RES, FWD_RES, 3), dtype=np.uint8)
    reqs = [{"rgb": image, "context_index": np.asarray([i])} for i in range(5)]
    solo, solo_s = [], []
    for i, r in enumerate(reqs):
        t0 = time.perf_counter()
        solo.append(pipe.generate(r, seed=i))
        solo_s.append(time.perf_counter() - t0)
    merged = {"rgb": np.concatenate([image] * 5), "context_index": np.arange(5)}
    direct_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        direct = pipe.generate(merged, normalize_normal=np.zeros(5, np.float32),
                               seed=list(range(5)))
        direct_s.append(time.perf_counter() - t0)

    ex = ServingExecutor(pipe, max_batch=5, max_wait_ms=2000)
    metrics.reset()
    fa.reset_counts()
    results, latency = [None] * 5, [0.0] * 5
    start = threading.Barrier(5)

    def client(i):
        start.wait(timeout=60)
        t0 = time.perf_counter()
        results[i] = ex.submit(reqs[i], seed=i).result(timeout=600)
        latency[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "server: a client did not return")
    launches = dict(fa.LAUNCHES)
    dispatch = metrics.summary()["serving/dispatch"]
    expected = 15 * 28 + 2
    rows = [{"psnr_vs_solo_db": psnr(r, s), "max_abs_vs_solo": int(np.abs(
        r.astype(int) - s.astype(int)).max()), "bitwise_direct": bool(np.array_equal(
            r, direct[i:i + 1]))} for i, (r, s) in enumerate(zip(results, solo))]
    rec = {"dispatches": dispatch["count"], "dispatch_s": dispatch["total_s"],
           "direct_5_row_generate_s": direct_s, "solo_generate_s": solo_s,
           "latency_s": latency, "latency_median_s": statistics.median(latency),
           # The server's own time: a request's latency outside its generate
           # (queue hand-off, host merge, futures), and the dispatch's
           # generate beside a direct one of the same rows.
           "server_overhead_s": statistics.median(latency) - dispatch["total_s"],
           "dispatch_minus_direct_median_s": dispatch["total_s"] - statistics.median(direct_s),
           "launches": launches, "expected_launches": expected, "rows": rows,
           "psnr_floor_db": SERVER_PSNR_DB}
    check(dispatch["count"] == 1, f"server: {dispatch['count']} dispatches, expected one of 5")
    for name in ("flash_attention", "flash_attention_headroom"):
        check(launches[name] == expected,
              f"server: {name} {launches[name]} launches, expected {expected}")
    for i, (r, row) in enumerate(zip(results, rows)):
        check(r.shape == (1, 1, FWD_RES, FWD_RES, 3) and r.dtype == np.uint8,
              f"server row {i}: {r.shape} {r.dtype}")
        check(row["bitwise_direct"], f"server row {i}: differs from the direct 5-row generate")
        check(row["psnr_vs_solo_db"] >= SERVER_PSNR_DB,
              f"server row {i}: {row['psnr_vs_solo_db']:.2f} dB from its solo run")

    # Two shape buckets in a trickle, then a drain with requests pending.
    small = {"rgb": rng.integers(0, 256, (1, 1, 256, 256, 3), dtype=np.uint8),
             "context_index": np.asarray([3])}
    metrics.reset()
    futs = []
    for i in range(6):
        futs.append(ex.submit(reqs[i % 5] if i % 2 == 0 else small, seed=i))
        time.sleep(0.02)
    pending = [ex.submit(reqs[i], seed=10 + i) for i in range(3)]
    ex.shutdown(drain=True, join_timeout=600)
    check(not ex._worker.is_alive(), "server: the worker outlived shutdown")
    for i, f in enumerate(futs + pending):
        check(f.done(), f"server: future {i} pending after shutdown(drain=True)")
        side = 256 if i < 6 and i % 2 else FWD_RES
        out = f.result(timeout=1)
        check(out.shape == (1, 1, side, side, 3), f"server: future {i} shape {out.shape}")
    rec["trickle_and_drain"] = {"requests": len(futs) + len(pending),
                                "dispatches": metrics.summary()["serving/dispatch"]["count"]}
    del pipe
    torch.cuda.empty_cache()
    say("surface_server " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# Training: the attention gradient, DiT gradients, 7B train steps, resume
# ---------------------------------------------------------------------------

# One 512x512 frame's DiT attention at batch 1 (a microbatch of the train step).
TRAIN_SHAPE = (1, 1024, 1024, 32, 128)
# bf16 kernel 3 + the plain backward vs fp32 autograd: relative L2 of dq, dk, dv.
TRAIN_ATTN_GRAD_TOL = 1e-2
# Each leaf's gradient of a 2-block, full-width DiT step in bf16 through the
# kernel vs the plain path in fp32: bf16 alone gives about 1e-2 (a 512-wide
# 2-block model on the CPU, bf16 vs fp32, both plain); a gradient cut at the
# attention leaves wq / wk / wv and the q / k norms at 100%.
TRAIN_DIT_GRAD_TOL = 5e-2
# The learning rate: make_optimizer's default, as in JAX.  At 3e-3 the
# 4096-wide model diverged within two steps (loss 5.1 -> 2,394 -> 848,417 on
# the H100).  At 1e-4 a bf16 weight of 1.0 (the RMSNorm scales at init)
# cannot move: AdamW's early steps are +-lr and half an ulp below 1.0 is
# 2^-9, so those leaves are held to a nonzero first moment instead.
TRAIN_LR = 1e-4
TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_train")
# The leaves the exact single-key cross-attention never reads: no gradient
# in the port, exactly zero in JAX; only AdamW's decay (lr * 0.01 * p, far
# below half a bf16 ulp) touches them.
UNUSED_CA = ("wq", "wk", "q_norm", "k_norm")


def fwd_bwd_bound(shape):
    """(bound_ms, bound_by) of an attention forward + backward: q, k, v and
    dO read, out, dq, dk, dv written once; 4 + 10 B*Lq*Lk*H*D operations
    (QK^T, PV; and QK^T again, dV, dP, dQ, dK) at the bf16 rate."""
    b, lq, lk, h, d = shape
    nbytes = (4 * lq + 2 * lk + 2 * lk) * b * h * d * 2
    t_bytes = nbytes / PEAK_BYTES
    t_ops = 14 * b * lq * lk * h * d / PEAK_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def train_attention_grad_phase():
    """(a) FlashAttentionFunction at the train step's attention shape: kernel
    3 forward + the plain backward vs autograd through attention_xla in
    fp32, and its forward + backward time beside SDPA's (a yardstick)."""
    import torch
    import torch.nn.functional as F
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops.attention import attention, attention_xla

    q, k, v = make_qkv(TRAIN_SHAPE, rms_normed=True, seed=30)
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(31),
                     device="cuda").bfloat16()
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))

    def kernel_path():
        out = attention(q, k, v, backend="pallas")
        return out, torch.autograd.grad(out, (q, k, v), do)

    fa.reset_counts()
    out, got = kernel_path()
    launches = dict(fa.VARIANT_LAUNCHES)
    check(launches["flash_attention_partial"] == 1 and fa.LAUNCHES["flash_attention"] == 0,
          f"attention under grad: launches {launches} {fa.LAUNCHES}, expected one kernel 3")
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    out_ref = attention_xla(qf, kf, vf)
    want = torch.autograd.grad(out_ref, (qf, kf, vf), do.float())
    rec = {"shape": list(TRAIN_SHAPE), "out_rel_l2": rel_l2(out, out_ref),
           "grad_rel_l2": {f"d{n}": rel_l2(g, w) for n, g, w in zip("qkv", got, want)},
           "tol": TRAIN_ATTN_GRAD_TOL}
    del qf, kf, vf, out_ref, want
    say("train_attention_grad " + json.dumps(rec))
    for name, err in rec["grad_rel_l2"].items():
        check(math.isfinite(err) and err <= TRAIN_ATTN_GRAD_TOL,
              f"attention gradient {name}: relative L2 {err:.3g} > {TRAIN_ATTN_GRAD_TOL}")

    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    def kernel3():
        with torch.no_grad():
            fa.flash_attention_partial(q.detach(), k.detach(), v.detach())

    # Event times, and queued times (every call enqueued behind a sleep
    # kernel: the device time alone, where a 0.05 ms launch would read the
    # host's launch rate).
    rec["kernel3_fwd_ms"], rec["kernel3_fwd_queued_ms"] = time_ms(kernel3, 20), queued_ms(kernel3, 20)
    rec["fwd_bwd_ms"], rec["fwd_bwd_queued_ms"] = time_ms(kernel_path, 10), queued_ms(kernel_path, 10)
    rec["plain_backward_ms"] = rec["fwd_bwd_queued_ms"] - rec["kernel3_fwd_queued_ms"]
    rec["library_fwd_bwd_ms"], rec["library_fwd_bwd_queued_ms"] = (time_ms(sdpa, 10),
                                                                   queued_ms(sdpa, 10))
    rec["bound_ms"], rec["bound_by"] = fwd_bwd_bound(TRAIN_SHAPE)
    rec["library"] = "F.scaled_dot_product_attention forward + backward, bf16 (a yardstick)"
    say("train_attention_grad " + json.dumps(rec))
    return rec


# Ring attention's gradient at phase 7's DiT attention shape, on one rank.
RING_SHAPE = (5, 1024, 1024, 32, 128)
# Phase 30(f)'s ring train steps against (c)'s first steps, loss by loss:
# the same weights, latents, draws and kernel 3, the ring's output rounded
# once more (o * l / l to bf16) and, after step 1, bf16 weights whose AdamW
# updates may round apart.  A key block or a gradient the ring dropped
# moves a 28-block DiT's loss by far more than 1%.
RING_LOSS_RTOL = 1e-2


def open_one_rank_mesh():
    """A one-rank NCCL process group (phase 16 closed its own) and its
    (1, 1, 1) mesh."""
    import torch.distributed as dist
    from diffusionrenderer_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
    check(dist.get_backend() == "nccl", f"process group backend {dist.get_backend()}, not nccl")
    return make_mesh(1, data=1, seq=1, tensor=1)


def ring_train_step(cfg, opt, mesh):
    """make_train_step's step at grad_accum 1 with edm_loss(attn_backend=
    'ring') on `mesh` (make_train_step, like JAX's, takes no attn_backend):
    step(state, batch, generator=None, *, draws=None) -> (state, loss)."""
    from diffusionrenderer_tpu_torch.parallel import token_sharding_constraint
    from diffusionrenderer_tpu_torch.training import TrainState, edm_loss
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves
    from diffusionrenderer_tpu_torch.utils.tree import tree_map

    constraint = token_sharding_constraint(mesh)

    def step(state, batch, generator=None, *, draws=None):
        params = state.params
        leaves = [p for p in tree_leaves(params) if p is not None]
        try:
            for p in leaves:
                p.grad = None
                p.requires_grad_(True)
            loss = edm_loss(params, batch["latents"], batch["latent_condition"],
                            batch["context_index"], generator, cfg, condition_drop_rate=0.1,
                            seq_sharding_constraint=constraint, attn_backend="ring",
                            draws=None if draws is None else draws[0])
            loss.backward()
            grads = tree_map(lambda p: p.grad, params)
        finally:
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None
        params, opt_state = opt.update(grads, state.opt_state, params)
        return TrainState(params, opt_state, state.step + 1), loss.detach()

    return step


def train_ring_grad_phase(mesh, attention_grad):
    """(e) Ring attention's gradient on the one-rank NCCL mesh at phase 7's
    DiT attention shape: RingAttentionFunction (one kernel-3 launch a
    forward, the plain backward ring) against FlashAttentionFunction on the
    same inputs and against fp32 autograd, within (a)'s bound; its forward
    + backward time beside the Function's and SDPA's at this shape, and
    (a)'s at batch 1."""
    import torch
    import torch.nn.functional as F
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops.attention import attention_xla
    from diffusionrenderer_tpu_torch.parallel.ring_attention import ring_attention_local

    q, k, v = make_qkv(RING_SHAPE, rms_normed=True, seed=36)
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(37),
                     device="cuda").bfloat16()
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))

    def grads(fn):
        def call():
            out = fn(q, k, v)
            return out, torch.autograd.grad(out, (q, k, v), do)
        return call

    ring = grads(lambda *t: ring_attention_local(*t, mesh))
    function = grads(fa.FlashAttentionFunction.apply)
    fa.reset_counts()
    out, got = ring()
    torch.cuda.synchronize()
    launches = fa.VARIANT_LAUNCHES["flash_attention_partial"]
    check(launches == 1 and fa.LAUNCHES["flash_attention"] == 0
          and type(out.grad_fn).__name__ == "RingAttentionFunctionBackward",
          f"ring under grad: {launches} kernel-3 launches {fa.LAUNCHES}, grad_fn "
          f"{type(out.grad_fn).__name__}; expected RingAttentionFunction and one kernel 3")
    want_out, want = function()
    rec = {"shape": list(RING_SHAPE), "mesh": "one-rank NCCL (1, 1, 1)",
           "kernel3_launches_per_forward": launches,
           "out_rel_l2_vs_function": rel_l2(out, want_out),
           "grad_rel_l2_vs_function": {f"d{n}": rel_l2(g, w) for n, g, w in zip("qkv", got, want)}}
    del want_out, want
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = attention_xla(qf, kf, vf)
    ref = torch.autograd.grad(ref, (qf, kf, vf), do.float())
    rec["grad_rel_l2_vs_fp32"] = {f"d{n}": rel_l2(g, w) for n, g, w in zip("qkv", got, ref)}
    rec["tol"] = TRAIN_ATTN_GRAD_TOL
    del qf, kf, vf, ref, out, got
    for what in ("grad_rel_l2_vs_function", "grad_rel_l2_vs_fp32"):
        for name, err in rec[what].items():
            check(math.isfinite(err) and err <= TRAIN_ATTN_GRAD_TOL,
                  f"ring attention gradient {name} ({what}): {err:.3g} > {TRAIN_ATTN_GRAD_TOL}")
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        o = F.scaled_dot_product_attention(qt, kt, vt)
        return torch.autograd.grad(o, (qt, kt, vt), dot)

    rec["fwd_bwd_ms"], rec["fwd_bwd_queued_ms"] = time_ms(ring, 5), queued_ms(ring, 5)
    rec["function_fwd_bwd_queued_ms"] = queued_ms(function, 5)
    rec["library_fwd_bwd_queued_ms"] = queued_ms(sdpa, 5)
    rec["library"] = "F.scaled_dot_product_attention forward + backward, bf16 (a yardstick)"
    rec["bound_ms"], rec["bound_by"] = fwd_bwd_bound(RING_SHAPE)
    rec["phase_30a_batch1"] = {k_: attention_grad[k_] for k_ in (
        "shape", "fwd_bwd_queued_ms", "library_fwd_bwd_queued_ms")}
    say("train_ring_grad " + json.dumps(rec))
    return rec


def train_ring_7b_steps(cfg, params, host, lat, seed, mesh, unsharded_steps):
    """(f) From (c)'s starting weights (`host`), 3 FADITV2_7B steps at batch
    1 through ring_train_step on the one-rank mesh with (c)'s latents and
    draws: 28 kernel-3 launches a step, each loss within RING_LOSS_RTOL of
    (c)'s step; step walls and the peak."""
    import gc

    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.training import init_train_state, make_optimizer
    from diffusionrenderer_tpu_torch.training.loop import step_generator
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    with torch.no_grad():
        for p, h in zip(tree_leaves(params), host):
            p.copy_(h)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = make_optimizer(TRAIN_LR)
    state = init_train_state(params, opt)
    step = ring_train_step(cfg, opt, mesh)
    rec = {"mesh": "one-rank NCCL (1, 1, 1)", "steps": [], "tol": RING_LOSS_RTOL}
    for i, want in enumerate(unsharded_steps):
        inputs = _train_inputs(1, i, lat)
        torch.cuda.synchronize()
        fa.reset_counts()
        t = time.perf_counter()
        state, loss = step(state, inputs, step_generator(seed, i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rec["steps"].append({"step": state.step, "loss": float(loss),
                             "unsharded_loss": want["loss"],
                             "rel_diff": abs(float(loss) - want["loss"]) / abs(want["loss"]),
                             "wall_s": wall, "unsharded_wall_s": want["wall_s"],
                             "kernel3_launches": fa.VARIANT_LAUNCHES["flash_attention_partial"],
                             "other_attention_launches": fa.LAUNCHES["flash_attention"]})
        say(f"  ring train step {state.step}: loss {float(loss):.6f} (unsharded "
            f"{want['loss']:.6f}), {wall:.3f} s")
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    say("train_ring_7b " + json.dumps(rec))
    for srec in rec["steps"]:
        check(srec["kernel3_launches"] == cfg.num_blocks and srec["other_attention_launches"] == 0,
              f"ring train step {srec['step']}: {srec['kernel3_launches']} kernel-3 launches, "
              f"expected {cfg.num_blocks}")
        check(math.isfinite(srec["loss"]) and srec["rel_diff"] <= RING_LOSS_RTOL,
              f"ring train step {srec['step']}: loss {srec['loss']} against the unsharded "
              f"step's {srec['unsharded_loss']} (rtol {RING_LOSS_RTOL})")
    del state
    return rec


def _train_inputs(batch: int, seed: int, lat=None, ctx=None):
    """A train batch: latents and conditions (B, 1, 64, 64, 16) bf16, from
    `lat` (rows of encoded latents) or seeded normals; context_index `ctx`,
    or 0-4 cycled."""
    import torch

    if lat is None:
        g = torch.Generator("cuda").manual_seed(seed)
        x0 = torch.randn(batch, 1, 64, 64, 16, generator=g, device="cuda").bfloat16()
        cond = torch.randn(batch, 1, 64, 64, 16, generator=g, device="cuda").bfloat16()
    else:
        x0 = torch.cat([lat["targets"][(seed + i) % len(lat["targets"])] for i in range(batch)])
        cond = lat["rgb"].expand(batch, -1, -1, -1, -1).contiguous()
    if ctx is None:
        ctx = [(seed * batch + i) % 5 for i in range(batch)]
    ctx = torch.tensor(ctx, device="cuda")
    return {"latents": x0, "latent_condition": cond, "context_index": ctx}


def _grads(params, batch, draws, cfg, backend):
    import torch
    from diffusionrenderer_tpu_torch.training import edm_loss
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = edm_loss(params, *batch.values(), None, cfg, condition_drop_rate=0.1, draws=draws,
                    attn_backend=backend)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), grads


def _leaf_names(params):
    from diffusionrenderer_tpu_torch.utils.tree import flatten

    return list(flatten(params, "params"))


def train_dit_grad_phase():
    """(b) One train step's gradients of a 2-block DiT at the full width
    (4096, 32 heads) in bf16 through the kernel path, leaf by leaf against
    the plain-attention path in fp32 (and the bf16 plain path beside it)."""
    import dataclasses

    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import init_dit_params
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.training.train import edm_draws
    from diffusionrenderer_tpu_torch.utils.tree import tree_map

    cfg = dataclasses.replace(get_inverse_renderer_config(512, 512, 1).net, num_blocks=2)
    params = init_dit_params(cfg, device="cuda", dtype=torch.bfloat16, seed=32)
    batch = _train_inputs(1, 32)
    draws = edm_draws(torch.Generator("cuda").manual_seed(33), batch["latents"])
    fa.reset_counts()
    loss16, g16 = _grads(params, batch, draws, cfg, "auto")
    launches = fa.VARIANT_LAUNCHES["flash_attention_partial"]
    check(launches == cfg.num_blocks and fa.LAUNCHES["flash_attention"] == 0,
          f"2-block train step: {launches} kernel-3 launches, expected {cfg.num_blocks}")
    _, g16_plain = _grads(params, batch, draws, cfg, "xla")
    p32 = tree_map(lambda t: t.float(), params)
    del params
    loss32, g32 = _grads(p32, {k: v.float() if v.is_floating_point() else v
                               for k, v in batch.items()}, draws, cfg, "xla")
    names = _leaf_names(p32)
    leaves, missing, unused = {}, [], []
    for name, a, a_plain, w in zip(names, g16, g16_plain, g32):
        if w is None or a is None:
            (unused if name.split("/")[-1] in UNUSED_CA and "/ca/" in name
             else missing).append(name)
            check((w is None) == (a is None), f"{name}: a gradient on one path only")
            continue
        leaves[name] = {"kernel_bf16": rel_l2(a, w), "plain_bf16": rel_l2(a_plain, w)}
    worst = max(leaves.items(), key=lambda kv: kv[1]["kernel_bf16"])
    rec = {"config": "FADITV2_7B width, 2 blocks", "tokens": 1024, "kernel3_launches": launches,
           "loss_bf16_kernel": float(loss16), "loss_fp32_plain": float(loss32),
           "leaves_with_gradient": len(leaves), "leaves_without": unused,
           "worst_leaf": worst[0], "worst_rel_l2": worst[1],
           "median_rel_l2_kernel": statistics.median(x["kernel_bf16"] for x in leaves.values()),
           "max_rel_l2_plain_bf16": max(x["plain_bf16"] for x in leaves.values()),
           "tol": TRAIN_DIT_GRAD_TOL, "attention_leaves": {
               n: leaves[n] for n in leaves if "/fa/" in n and n.startswith("params/blocks/0/")}}
    say("train_dit_grad " + json.dumps(rec))
    check(not missing, f"leaves with no gradient: {missing}")
    check(len(unused) == len(UNUSED_CA) * cfg.num_blocks,
          f"expected the {len(UNUSED_CA) * cfg.num_blocks} unused cross-attention leaves "
          f"without a gradient, got {unused}")
    for name, errs in leaves.items():
        check(math.isfinite(errs["kernel_bf16"]) and errs["kernel_bf16"] <= TRAIN_DIT_GRAD_TOL,
              f"{name}: gradient relative L2 {errs['kernel_bf16']:.3g} > {TRAIN_DIT_GRAD_TOL}")
    return rec


def profile_train_step(step, state, inputs, generator, opt):
    """torch.profiler over one train step: device time by kernel class
    (the fused AdamW's apart), the idle share of the wall time, and
    the stream time of the attention backwards and of the AdamW update,
    each between CUDA events recorded around its calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    backward, update = fa.flash_attention_backward_plain, opt.update
    spans = {"attention_backward": [], "adamw": []}

    def timed(name, fn):
        def call(*args, **kw):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            stop.record()
            spans[name].append((start, stop))
            return out
        return call

    fa.flash_attention_backward_plain = timed("attention_backward", backward)
    opt.update = timed("adamw", update)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, loss = step(state, inputs, generator)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fa.flash_attention_backward_plain = backward
        del opt.update  # the instance attribute: AdamW.update again
    classes = {"gemm": 0.0, "flash_attention": 0.0, "adamw": 0.0,
               "elementwise/other": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Command Buffer"):
            continue
        dev_ms = (ev.self_device_time_total if hasattr(ev, "self_device_time_total")
                  else ev.self_cuda_time_total) / 1e3
        name, low = ev.key, ev.key.lower()
        if "partial_kernel" in name or "attention_kernel" in name:
            cls = "flash_attention"
        elif "multi_tensor_apply" in name:  # the fused AdamW (and its count's add)
            cls = "adamw"
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "gemm"
        else:
            cls = "elementwise/other"
        classes[cls] += dev_ms
        top.append((dev_ms, ev.count, name[:80]))
    busy = sum(classes.values())
    top.sort(reverse=True)
    rec = {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1 - busy / wall_ms,
           "by_class_ms": classes, "loss": float(loss),
           **{f"{k}_stream_ms": sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()},
           "attention_backward_calls": len(spans["attention_backward"]),
           "top": [[round(t, 3), c, n] for t, c, n in top[:12]]}
    say("profile_train_step " + json.dumps(rec))
    return state, rec


def train_7b_setup(seed: int):
    """load_pipeline()'s FADITV2_7B inverse DiT in bf16 and the VAE-encoded
    latents of three seeded 512x512 clips (the first a condition, the
    others targets): (DiT config, params, latents, seconds)."""
    import gc

    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch import load_pipeline
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config

    t0 = time.perf_counter()
    pipe = load_pipeline()
    cfg = get_inverse_renderer_config(512, 512, 1).net  # load_pipeline's inverse DiT
    rng = np.random.default_rng(seed)
    clips = torch.from_numpy(rng.uniform(-1, 1, (3, 1, 512, 512, 3)).astype(np.float32))
    with torch.no_grad():
        z = pipe.encode(clips.to("cuda", torch.bfloat16))  # (3, 1, 64, 64, 16), * sigma_data
    lat = {"rgb": z[:1], "targets": [z[1:2], z[2:3]]}
    params = pipe.dit_params
    del pipe, z
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, params, lat, time.perf_counter() - t0


def train_7b_phase(seed: int = 34, ring_mesh=None):
    """(c) The full 28-block FADITV2_7B in bf16 (load_pipeline's seeded
    weights) takes 3 train steps at batch 1 and 2 at batch 2 with
    grad_accum=2, condition dropout 0.1, on latents of seeded 512x512 clips
    from the port's VAE encode: step losses and wall times, the peak, kernel
    3's launches per step, and a sixth step at batch 1 under torch.profiler;
    every leaf that has a gradient got a nonzero first moment, and moved
    unless it is an RMSNorm scale.  Then, on ring_mesh, (f) from the same
    starting weights (train_ring_7b_steps)."""
    import gc

    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.training import (init_train_state, make_optimizer,
                                                      make_train_step)
    from diffusionrenderer_tpu_torch.training.loop import step_generator
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"start_allocated_gib": torch.cuda.memory_allocated() / GIB,
           "route": "replayed graph (steps 1 and 4 eager, then captured)"}
    cfg, params, lat, rec["setup_s"] = train_7b_setup(seed)
    rec["weights_gib"] = sum(p.numel() * p.element_size() for p in tree_leaves(params)) / GIB
    names = _leaf_names(params)
    host = [p.to("cpu", copy=True) for p in tree_leaves(params)]
    opt = make_optimizer(TRAIN_LR)
    state = init_train_state(params, opt)
    steps = {1: make_train_step(cfg, opt, condition_drop_rate=0.1),
             2: make_train_step(cfg, opt, condition_drop_rate=0.1, grad_accum=2)}
    rec["steps"] = []
    for i, (batch, accum) in enumerate(((1, 1), (1, 1), (1, 1), (2, 2), (2, 2))):
        inputs = _train_inputs(batch, i, lat)
        torch.cuda.synchronize()
        fa.reset_counts()
        t = time.perf_counter()
        state, loss = steps[accum](state, inputs, step_generator(seed, i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rec["steps"].append({"step": state.step, "batch": batch, "grad_accum": accum,
                             "loss": float(loss), "wall_s": wall,
                             "kernel3_launches": fa.VARIANT_LAUNCHES["flash_attention_partial"],
                             "other_attention_launches": fa.LAUNCHES["flash_attention"]})
        say(f"  train step {state.step}: batch {batch}, grad_accum {accum}, loss "
            f"{float(loss):.6f}, {wall:.3f} s")
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / GIB
    rec["params_grads_moments_gib"] = 4 * rec["weights_gib"]
    # The profiled sixth step runs eagerly (its spans time Python calls,
    # which a replay makes none of), after the graphs' pool is released:
    # the pool and an eager step's gradients do not fit the card together.
    for s_ in steps.values():
        s_._graphs.clear()
        s_._eager = True
    gc.collect()
    torch.cuda.empty_cache()
    fa.reset_counts()
    state, rec["profile_step6"] = profile_train_step(steps[1], state, _train_inputs(1, 5, lat),
                                                     step_generator(seed, 5), opt)
    check(fa.VARIANT_LAUNCHES["flash_attention_partial"] == cfg.num_blocks,
          "profiled train step: kernel-3 launches")
    unused = {n for n in names if "/ca/" in n and n.split("/")[-1] in UNUSED_CA}
    scales = {n for n in names if n.endswith(("/q_norm", "/k_norm", "affline_norm/weight"))}
    unmoved, zero_mu = set(), set()
    for name, before, after, mu in zip(names, host, tree_leaves(state.params),
                                       tree_leaves(state.opt_state.mu)):
        if torch.equal(before.to("cuda"), after):
            unmoved.add(name)
        if not bool(mu.any()):
            zero_mu.add(name)
    rec["leaves"] = len(names)
    rec["moved_leaves"] = len(names) - len(unmoved)
    rec["unmoved_rmsnorm_scales"] = len(unmoved & scales - unused)
    rec["unused_ca_leaves"] = len(unused)
    rec["zero_first_moment_leaves"] = len(zero_mu)
    say("train_7b " + json.dumps(rec))
    for srec in rec["steps"]:
        check(math.isfinite(srec["loss"]), f"train step {srec['step']}: loss {srec['loss']}")
        want = cfg.num_blocks * srec["grad_accum"]
        check(srec["kernel3_launches"] == want and srec["other_attention_launches"] == 0,
              f"train step {srec['step']}: {srec['kernel3_launches']} kernel-3 launches, "
              f"expected {want} (28 per microbatch forward)")
    # Every leaf with a gradient got a nonzero first moment and moved, but
    # the RMSNorm scales (ones: no bf16 step of lr reaches them); the unused
    # cross-attention leaves have a zero first moment, as in JAX.
    check(zero_mu == unused, f"first moment zero on {sorted(zero_mu ^ unused)[:8]} beyond the "
                             f"{len(unused)} unused cross-attention leaves")
    check(unmoved <= unused | scales,
          f"leaves with a gradient that did not move: {sorted(unmoved - unused - scales)[:8]}")
    if ring_mesh is not None:
        params = state.params  # updated in place: (c)'s weights
        del state
        rec["ring"] = train_ring_7b_steps(cfg, params, host, lat, seed, ring_mesh,
                                          rec["steps"][:3])
    else:
        del state
    del params, host
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# (d)'s runs: (batch, grad_accum, context_index).  The second repeats each
# context index within a microbatch, so the backward of the context table's
# gather sums rows that share an index.
TRAIN_RESUME_RUNS = ((1, 1, None), (4, 2, [2, 2, 4, 4]))


def train_resume_phase(seed: int = 35):
    """(d) train_loop at 2 blocks, full width, for each of TRAIN_RESUME_RUNS:
    4 steps straight with save_every=2, and 2 steps then a resume and 2
    more, bitwise equal (parameters, both moments, losses); save and
    restore seconds."""
    import dataclasses
    import shutil

    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import init_dit_params
    from diffusionrenderer_tpu_torch.training import (init_train_state, make_optimizer,
                                                      make_train_step, train_loop)
    from diffusionrenderer_tpu_torch.training.loop import (restore_train_state,
                                                           save_train_state)
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    cfg = dataclasses.replace(get_inverse_renderer_config(512, 512, 1).net, num_blocks=2)
    opt = make_optimizer(TRAIN_LR)

    def make_state():
        return init_train_state(init_dit_params(cfg, device="cuda", dtype=torch.bfloat16,
                                                seed=seed), opt)

    def leaves(s):
        return tree_leaves([s.params, s.opt_state.mu, s.opt_state.nu])

    rec = {"runs": []}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    os.makedirs(TRAIN_DIR)
    try:
        for batch, accum, ctx in TRAIN_RESUME_RUNS:
            step = make_train_step(cfg, opt, condition_drop_rate=0.1, grad_accum=accum)

            def batch_fn(i, batch=batch, ctx=ctx):
                return _train_inputs(batch, 100 + i, ctx=ctx)

            def run(sub, n, step=step, batch_fn=batch_fn):
                return train_loop(make_state, step, batch_fn, num_steps=n, seed=seed,
                                  ckpt_dir=os.path.join(TRAIN_DIR, sub), save_every=2,
                                  max_to_keep=1, log_every=0)

            tag = f"b{batch}_accum{accum}"
            full, losses_full = run(f"{tag}_full", 4)
            _, head = run(f"{tag}_cut", 2)
            resumed, tail = run(f"{tag}_cut", 4)
            differ = sum(not torch.equal(a, b) for a, b in zip(leaves(full), leaves(resumed)))
            rec["runs"].append({
                "batch": batch, "grad_accum": accum, "context_index": ctx,
                "losses_straight": losses_full, "losses_cut_then_resumed": head + tail,
                "leaves": len(leaves(full)), "leaves_differing": differ,
                "step": [full.step, resumed.step],
                "count": [full.opt_state.count, resumed.opt_state.count]})
            if len(rec["runs"]) == 1:
                torch.cuda.synchronize()
                t = time.perf_counter()
                path = save_train_state(os.path.join(TRAIN_DIR, "timing"), full)
                rec["save_s"] = time.perf_counter() - t
                t = time.perf_counter()
                back = restore_train_state(path)
                torch.cuda.synchronize()
                rec["restore_s"] = time.perf_counter() - t
                rec["save_restore_bitwise"] = all(
                    torch.equal(a, b) for a, b in zip(leaves(full), leaves(back), strict=True))
                rec["state_gib"] = sum(x.numel() * x.element_size() for x in leaves(full)) / GIB
                del back
            del full, resumed
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    say("train_resume " + json.dumps(rec))
    for r in rec["runs"]:
        what = f"resume at batch {r['batch']}, grad_accum {r['grad_accum']}"
        check(r["losses_cut_then_resumed"] == r["losses_straight"],
              f"{what}: the losses differ from the straight run")
        check(r["leaves_differing"] == 0 and r["step"] == [4, 4] and r["count"] == [4, 4],
              f"{what}: {r['leaves_differing']} of {r['leaves']} leaves differ from the "
              f"straight run")
    check(rec["save_restore_bitwise"], "save_train_state / restore_train_state is not bitwise")
    return rec


# ---------------------------------------------------------------------------
# Phase 31: several ranks on the one card, over gloo
# ---------------------------------------------------------------------------

# Each part's ranks write their records here (build/ is not committed);
# main() removes it.
MULTI_DIR = os.path.join(ROOT, "build", "chip_smoke_multirank")
MULTI_RANK_TIMEOUT_S = 420
# (b)'s render runs 5 of the 15 steps: every step's collectives are staged
# through the host (about 4 s a step on 4 ranks), and the launch count and
# the output checks need no more.
MULTI_RANK_RENDER_STEPS = 5
PROBE_OPS = ("all_reduce", "all_reduce_max", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single", "all_to_all_single_one_split", "broadcast",
             "batch_isend_irecv")
PROBE_DTYPES = ("bfloat16", "float32")
# The collectives the port's multi-rank path calls (parallel/collectives.py);
# point-to-point is not among them.
PORT_OPS = PROBE_OPS[:-1]
# Kernel 4 at the tensor = 2 shard shapes of the DiT's W8A8 block matmuls
# at 5 x 1024 tokens, (M, K, N): fa wq / wk / wv, fa wo, mlp w1, mlp w2.
QMM_TP_SHAPES = ((5120, 4096, 2048), (5120, 2048, 4096), (5120, 4096, 8192),
                 (5120, 8192, 4096))
# Kernel 2 (the online branch, flash_sp on the all-gathered KV) at the
# per-rank shapes, (B, Lq, Lk, H, D): the (1, 2, 2) render's and the
# (1, 1, 2) forwards'.
ATTN_TP_SHAPES = ((5, 512, 1024, 16, 128), (5, 1024, 1024, 16, 128))
MULTI_FWD_TOL = 2e-2  # phase 16's bound: a sharded forward vs the unsharded one
# Phase 11's bound for a W8A8 forward under ulp-level perturbations (its
# kernel path vs plain path): the int8 activation codes move across .5
# boundaries at every block matmul.
W8A8_PERTURB_TOL = 0.1
HOST_STAGED = ("host-staged: gloo carries the CUDA tensors through the host, so these times "
               "are not speed numbers for a sharded path over NCCL")


def _probe_rank(rank, world, start):
    """Each collective on CUDA tensors, from case `start` on; rank 0 appends
    one JSON line per case to probe.jsonl.  A rank that crashes ends the
    spawn; the caller starts the next case in a new one."""
    import torch
    import torch.distributed as dist

    cases = [(op, dn) for op in PROBE_OPS for dn in PROBE_DTYPES][start:]
    for op, dn in cases:
        dt = getattr(torch, dn)

        def mine(r):
            return torch.arange(8, device="cuda", dtype=torch.float32).reshape(4, 2) + 10 * r

        x = mine(rank).to(dt)
        nxt, prv = (rank + 1) % world, (rank - 1) % world
        try:
            if op.startswith("all_reduce"):
                y = x.clone()
                if op == "all_reduce":
                    dist.all_reduce(y)
                    want = sum(mine(r) for r in range(world))
                else:
                    dist.all_reduce(y, op=dist.ReduceOp.MAX)
                    want = mine(world - 1)
            elif op == "all_gather_into_tensor":
                y = torch.empty(4 * world, 2, dtype=dt, device="cuda")
                dist.all_gather_into_tensor(y, x)
                want = torch.cat([mine(r) for r in range(world)])
            elif op == "reduce_scatter_tensor":
                y = torch.empty(4 // world, 2, dtype=dt, device="cuda")
                dist.reduce_scatter_tensor(y, x)
                want = sum(mine(r) for r in range(world)).chunk(world)[rank]
            elif op == "all_to_all_single":
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x)
                want = torch.cat([mine(r).chunk(world)[rank] for r in range(world)])
            elif op == "all_to_all_single_one_split":  # the port's rotation
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x, [4 if r == prv else 0 for r in range(world)],
                                       [4 if r == nxt else 0 for r in range(world)])
                want = mine(prv)
            elif op == "batch_isend_irecv":
                y = torch.empty_like(x)
                for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt),
                                                   dist.P2POp(dist.irecv, y, prv)]):
                    req.wait()
                want = mine(prv)
            else:  # broadcast
                y = x.clone()
                dist.broadcast(y, 0)
                want = mine(0)
            torch.cuda.synchronize()
            res = "ok" if torch.equal(y.float(), want.float()) else "wrong values"
        except RuntimeError as e:
            res = f"refused: {str(e).splitlines()[0][:160]}"
        if rank == 0:
            with open(os.path.join(MULTI_DIR, "probe.jsonl"), "a") as f:
                f.write(json.dumps({"op": op, "dtype": dn, "result": res}) + "\n")
        dist.barrier()
    return {}


def _weights_gib(tree) -> float:
    from diffusionrenderer_tpu_torch.utils.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree) if t is not None) / 2 ** 30


def _render_rank(rank, world, _):
    """(b) JAX's default mesh, make_mesh() -> (1, 2, 2): load_pipeline() at
    full width, one rank at a time (so the card never holds four whole
    models), shard(mesh), inverse_render of phase 7's image; one DiT
    forward on the mesh vs rank 0's unsharded kernel-path forward."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from diffusionrenderer_tpu_torch.api import INVERSE_PASSES, inverse_render, load_pipeline
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import dit_forward
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.parallel import make_mesh, token_sharding_constraint

    mesh = make_mesh()
    shape = tuple(mesh.shape.values())
    check(shape == (1, 2, 2), f"make_mesh() on 4 ranks gave {shape}, JAX's rule gives (1, 2, 2)")
    net = get_inverse_renderer_config(512, 512, 1).net
    x, sigma, cond, ctx = dit_inputs(6)
    ref = None
    torch.cuda.reset_peak_memory_stats()
    for turn in range(world):
        if turn == rank:
            t0 = time.perf_counter()
            pipe = load_pipeline()
            if rank == 0:
                with torch.no_grad():
                    ref = dit_forward(pipe.dit_params, x, sigma, cond, ctx, net)
                    ref_online = dit_forward(pipe.dit_params, x, sigma, cond, ctx, net,
                                             attn_backend="pallas_onlinemax")
            pipe.shard(mesh)
            pipe.num_steps = MULTI_RANK_RENDER_STEPS
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        dist.barrier()
    rec = {"mesh": shape, "rank": rank, "coords": mesh.coords,
           "dit_weights_gib": _weights_gib(pipe.dit_params),
           "vae_weights_gib": _weights_gib(pipe.vae_params), "load_and_shard_s": load_s,
           "load_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    image = np.random.default_rng(0).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_counts()
    t0 = time.perf_counter()
    out = inverse_render(pipe, image)
    torch.cuda.synchronize()
    rec["inverse_render_wall_s_host_staged"] = time.perf_counter() - t0
    rec["num_steps"] = pipe.num_steps
    rec["render_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rec["launches"] = dict(fa.LAUNCHES)
    rec["branches"] = fa.branch_counts("cuda")
    rec["timings_s_host_staged"] = dict(pipe.timings)
    check(sorted(out) == sorted(INVERSE_PASSES), f"passes {sorted(out)}")
    for name, arr in out.items():
        check(arr.shape == (1, 512, 512, 3), f"{name} shape {arr.shape}")
        check(bool(np.isfinite(arr).all()) and arr.min() >= 0.0 and arr.max() <= 1.0,
              f"{name}: values not finite in [0, 1]")
    # The DiT's attention on the all-gathered KV (kernel 2, no headroom
    # launch) once per block and step; the VAE's two bounded calls.
    dit_calls = pipe.num_steps * net.num_blocks
    check(rec["launches"]["flash_attention"] == dit_calls + 2
          and rec["launches"]["flash_attention_headroom"] == 2,
          f"rank {rank}: attention launches {rec['launches']}, expected {dit_calls} + 2 and 2")
    with torch.no_grad():
        got = dit_forward(pipe.dit_params, x, sigma, cond, ctx, net,
                          seq_sharding_constraint=token_sharding_constraint(mesh))
    check(bool(torch.isfinite(got).all()), f"rank {rank}: sharded forward not finite")
    if rank == 0:
        rec["forward_vs_unsharded_rel_l2"] = rel_l2(got, ref)
        # The same attention branch as the mesh's (kernel 2, online).
        rec["forward_vs_unsharded_online_rel_l2"] = rel_l2(got, ref_online)
        check(rec["forward_vs_unsharded_rel_l2"] <= MULTI_FWD_TOL,
              f"the (1, 2, 2) forward is {rec['forward_vs_unsharded_rel_l2']:.3g} from the "
              f"unsharded kernel path (bound {MULTI_FWD_TOL})")
    say(f"  [rank {rank}] multirank_render " + json.dumps(rec))
    return rec


def _shard_block(bp, mesh):
    """One block's dict cut to this rank's tensor-parallel shard."""
    from diffusionrenderer_tpu_torch.parallel import dit_param_shardings, shard_params

    tree = {"blocks": [bp]}
    return shard_params(tree, dit_param_shardings(tree, mesh))["blocks"][0]


def _w8a8_tp_part(rank, x, sigma, cond, ctx, net):
    """(c) W8A8 and W8A8-g128 forwards at tensor = 2, (1, 1, 2), against
    rank 0's unsharded forward through the same attention branch (kernel
    2, online: the mesh's), at 1, 4 and 28 blocks; 'auto' reported beside
    it.  Rank 0 draws the whole quantized model and then keeps its shard;
    rank 1 cuts each block as it is drawn.

    Per channel the row-parallel integer sums are added exactly, so the
    sharded forward is the unsharded one's at every depth (2e-2).  Per
    group each rank folds its own groups in fp32 and the folds are added:
    a rounding of the fold's order at one block (2e-2 at depth 1), which
    the W8A8 activation codes amplify through 28 blocks like any ulp-level
    perturbation (phase 11's bound for those, W8A8_PERTURB_TOL)."""
    import functools

    import torch
    from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
    from diffusionrenderer_tpu_torch.models.quant import is_quantized, quantize_block
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm
    from diffusionrenderer_tpu_torch.parallel import (dit_param_shardings, make_mesh,
                                                      shard_params, token_sharding_constraint)

    mesh = make_mesh(2, data=1, seq=1, tensor=2)
    constraint = token_sharding_constraint(mesh)
    depths = (1, 4, net.num_blocks)

    def upto(p, n):
        return dict(p, blocks=p["blocks"][:n])

    out = {}
    for label, group in (("w8a8", None), ("w8a8_g128", 128)):
        quant = functools.partial(quantize_block, act_quant=True, group_size=group)
        refs = ref_auto = None
        if rank == 0:
            full = init_dit_params(net, device="cuda", dtype=torch.bfloat16, seed=0,
                                   block_fn=quant)
            with torch.no_grad():
                refs = {n: dit_forward(upto(full, n), x, sigma, cond, ctx, net,
                                       attn_backend="pallas_onlinemax") for n in depths}
                ref_auto = dit_forward(full, x, sigma, cond, ctx, net)
            params = shard_params(full, dit_param_shardings(full, mesh))
            del full
        else:
            params = init_dit_params(net, device="cuda", dtype=torch.bfloat16, seed=0,
                                     block_fn=lambda bp: _shard_block(quant(bp), mesh))
        torch.cuda.empty_cache()
        rows = x.shape[0] * x.shape[2] * x.shape[3] // 4  # tokens: 2x2 patches
        shapes = sorted({(rows, w["q"].shape[1], w["q"].shape[0])
                         for sub in ("fa", "mlp") for w in params["blocks"][0][sub].values()
                         if is_quantized(w)})
        with torch.no_grad():
            gots = {n: dit_forward(upto(params, n), x, sigma, cond, ctx, net,
                                   seq_sharding_constraint=constraint) for n in depths[:-1]}
            qm.reset_counts()
            t0 = time.perf_counter()
            gots[depths[-1]] = dit_forward(params, x, sigma, cond, ctx, net,
                                           seq_sharding_constraint=constraint)
            torch.cuda.synchronize()
        got = gots[depths[-1]]
        rec = {"mesh": (1, 1, 2), "launches": qm.LAUNCHES["quant_matmul_w8a8"],
               "shard_shapes_mkn": shapes, "weights_gib": _weights_gib(params),
               "forward_s_host_staged": time.perf_counter() - t0}
        check(rec["launches"] == 6 * net.num_blocks,
              f"rank {rank} {label}: {rec['launches']} kernel-4 launches, expected "
              f"{6 * net.num_blocks}")
        check(shapes == sorted(QMM_TP_SHAPES), f"rank {rank} {label}: shard shapes {shapes}")
        check(bool(torch.isfinite(got).all()), f"rank {rank} {label}: forward not finite")
        if rank == 0:
            by_depth = {n: rel_l2(gots[n], refs[n]) for n in depths}
            rec["vs_unsharded_rel_l2_by_depth"] = by_depth
            rec["vs_unsharded_rel_l2"] = by_depth[depths[-1]]
            rec["vs_unsharded_auto_rel_l2"] = rel_l2(got, ref_auto)
            bounds = ({n: MULTI_FWD_TOL for n in depths} if group is None else
                      {depths[0]: MULTI_FWD_TOL, depths[1]: W8A8_PERTURB_TOL,
                       depths[-1]: W8A8_PERTURB_TOL})
            rec["bounds_by_depth"] = bounds
            for n in depths:
                check(by_depth[n] <= bounds[n],
                      f"{label} at tensor = 2, {n} blocks: {by_depth[n]:.3g} from the unsharded "
                      f"W8A8 forward through the same attention (bound {bounds[n]})")
        out[label] = rec
        say(f"  [rank {rank}] multirank_{label} " + json.dumps(
            {k: v for k, v in rec.items() if k != "shard_shapes_mkn"}))
        del params, refs, ref_auto, got, gots
        torch.cuda.empty_cache()
    return out


def _gpipe_part(rank, x, sigma, cond, ctx, net):
    """(d) GPipe on make_pp_mesh(2): the 28-block DiT, 14 blocks per rank,
    M = 5, against rank 0's unsharded forward."""
    import torch
    from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.parallel import (make_pp_executor, make_pp_mesh,
                                                      pp_block_shardings)

    pmesh = make_pp_mesh(2)
    per = net.num_blocks // 2
    ref = None
    if rank == 0:
        params = init_dit_params(net, device="cuda", dtype=torch.bfloat16, seed=0)
        with torch.no_grad():
            ref = dit_forward(params, x, sigma, cond, ctx, net)
        params["blocks"] = pp_block_shardings(pmesh)(params["blocks"])
    else:
        index = iter(range(net.num_blocks))
        params = init_dit_params(net, device="cuda", dtype=torch.bfloat16, seed=0,
                                 block_fn=lambda bp: bp if next(index) // per == rank else None)
    torch.cuda.empty_cache()
    m = x.shape[0]
    fa.reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        got = dit_forward(params, x, sigma, cond, ctx, net,
                          block_executor=make_pp_executor(pmesh, m))
    torch.cuda.synchronize()
    rec = {"stages": 2, "microbatches": m, "blocks_here": sum(b is not None
                                                              for b in params["blocks"]),
           "launches": dict(fa.LAUNCHES), "weights_gib": _weights_gib(params),
           "forward_s_host_staged": time.perf_counter() - t0}
    # Every tick (M + S - 1 of them, the bubble's included) runs this
    # stage's blocks, each one bounded attention call.
    calls = (m + 1) * per
    check(rec["launches"]["flash_attention"] == calls
          and rec["launches"]["flash_attention_headroom"] == calls,
          f"rank {rank} GPipe: launches {rec['launches']}, expected {calls} each")
    check(bool(torch.isfinite(got).all()), f"rank {rank} GPipe: forward not finite")
    if rank == 0:
        rec["vs_unsharded_rel_l2"] = rel_l2(got, ref)
        check(rec["vs_unsharded_rel_l2"] <= MULTI_FWD_TOL,
              f"GPipe forward: {rec['vs_unsharded_rel_l2']:.3g} from the unsharded forward")
    del params
    torch.cuda.empty_cache()
    return rec


def _gather_whole(grads, mode, mesh, shardings, nb):
    """The whole gradient tree on every rank: tensor shards gathered over
    the tensor group; each GPipe block broadcast from its stage."""
    import torch.distributed as dist
    from diffusionrenderer_tpu_torch.parallel.collectives import gather_replicated

    if mode == "tensor2":
        def whole(g, sh):
            if isinstance(g, dict):
                return {k: whole(g[k], sh[k]) for k in g}
            if isinstance(g, list):
                return [whole(a, b) for a, b in zip(g, sh)]
            if g is None or sh.dim is None:
                return g
            return gather_replicated(g, mesh.tensor_group, sh.dim)

        return whole(grads, shardings)
    if mode == "gpipe2":
        import torch

        per = nb // mesh.pipe
        template = grads["blocks"][mesh.coords[1] * per]
        blocks = []
        for i in range(nb):
            owner = i // per
            mine = grads["blocks"][i]
            block = {}
            for sub, sp in template.items():
                block[sub] = {}
                for name, g in sp.items():
                    if g is None:  # unused on every stage alike
                        block[sub][name] = None
                        continue
                    t = mine[sub][name] if owner == mesh.coords[1] else torch.empty_like(g)
                    dist.broadcast(t, src=owner)
                    block[sub][name] = t
            blocks.append(block)
        return dict(grads, blocks=blocks)
    return grads


def _ring_attention_part(rank):
    """(e)(i) Ring attention's gradient on (1, 2, 1), 512 tokens a rank at
    RING_SHAPE: kernel 3 twice a rank a forward (RingAttentionFunction),
    the gradients gathered whole against rank 0's unsharded
    FlashAttentionFunction on the same inputs (phase 30(a)'s bound)."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.parallel import gather_tokens, make_mesh, token_slice
    from diffusionrenderer_tpu_torch.parallel.ring_attention import ring_attention_local

    mesh = make_mesh(2, data=1, seq=2, tensor=1)
    q, k, v = make_qkv(RING_SHAPE, rms_normed=True, seed=36)
    do = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(37),
                     device="cuda").bfloat16()
    local = [token_slice(t, mesh).contiguous().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    fa.reset_counts()
    t0 = time.perf_counter()
    out = ring_attention_local(*local, mesh)
    forward_launches = fa.VARIANT_LAUNCHES["flash_attention_partial"]
    grads = torch.autograd.grad(out, local, token_slice(do, mesh))
    torch.cuda.synchronize()
    rec = {"shape": list(RING_SHAPE), "mesh": "(1, 2, 1) gloo", "tokens_per_rank": out.shape[1],
           "fwd_bwd_s_host_staged": time.perf_counter() - t0,
           "kernel3_launches_forward": forward_launches,
           "kernel3_launches_fwd_bwd": fa.VARIANT_LAUNCHES["flash_attention_partial"],
           "grad_fn": type(out.grad_fn).__name__}
    whole_out = gather_tokens(out.detach(), mesh)
    whole = [gather_tokens(g, mesh) for g in grads]
    if rank == 0:
        ref = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref_out = fa.FlashAttentionFunction.apply(*ref)
        want = torch.autograd.grad(ref_out, ref, do)
        rec["out_rel_l2_vs_unsharded"] = rel_l2(whole_out, ref_out)
        rec["grad_rel_l2_vs_unsharded"] = {f"d{n}": rel_l2(g, w)
                                           for n, g, w in zip("qkv", whole, want)}
        rec["tol"] = TRAIN_ATTN_GRAD_TOL
        for name, err in rec["grad_rel_l2_vs_unsharded"].items():
            check(math.isfinite(err) and err <= TRAIN_ATTN_GRAD_TOL,
                  f"2-rank ring gradient {name}: {err:.3g} from the unsharded Function's")
    say(f"  [rank {rank}] multirank_ring_attention " + json.dumps(rec))
    check(forward_launches == 2 and rec["kernel3_launches_fwd_bwd"] == 2
          and rec["grad_fn"] == "RingAttentionFunctionBackward",
          f"2-rank ring: {forward_launches} kernel-3 launches a forward "
          f"({rec['kernel3_launches_fwd_bwd']} with the backward), grad_fn {rec['grad_fn']}; "
          f"expected 2 and RingAttentionFunction")
    del q, k, v, do, local, out, grads, whole
    torch.cuda.empty_cache()
    return rec


def _train_part(rank, net):
    """(e) The sharded train step at full width, 4 blocks: every leaf's
    gradient of one loss at tensor = 2, data = 2, GPipe S = 2, seq = 2 on
    the all-gathered KV and seq = 2 through ring attention (8 kernel-3
    launches a rank), gathered whole, against rank 0's unsharded fp32
    plain path and its unsharded bf16 kernel path (phase 30(b)'s bound):
    within the bound of both, or, where the unsharded bf16 path is itself
    past it from fp32 (at 4 blocks the q / k side of blocks 1-3), of that
    path; the ring, which rounds apart from it, there no further from fp32
    than it by more than the bound.  Then one AdamW step on each mesh
    (make_train_step; ring_train_step for the ring)."""
    import dataclasses

    import torch
    from diffusionrenderer_tpu_torch.models.dit import init_dit_params
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.parallel import (dit_param_shardings, make_mesh,
                                                      make_pp_executor, make_pp_mesh,
                                                      pp_block_shardings, shard_params,
                                                      token_sharding_constraint)
    from diffusionrenderer_tpu_torch.training import (edm_loss, init_train_state,
                                                      make_optimizer, make_train_step)
    from diffusionrenderer_tpu_torch.training.train import edm_draws
    from diffusionrenderer_tpu_torch.utils.tree import flatten, leaves, tree_map

    cfg = dataclasses.replace(net, num_blocks=4)
    batch = _train_inputs(2, 41)
    draws = edm_draws(torch.Generator("cuda").manual_seed(42), batch["latents"])
    ref = ref16 = spread16 = None
    if rank == 0:
        # The unsharded fp32 plain path (the bound's reference) and, beside
        # it, the unsharded bf16 kernel path; the unsharded bf16 plain path
        # gives the spread of two bf16 attentions that round apart.
        p32 = init_dit_params(cfg, device="cuda", dtype=torch.float32, seed=40)
        _, g32 = _grads(p32, {k: v.float() if v.is_floating_point() else v
                              for k, v in batch.items()}, draws, cfg, "xla")
        ref = dict(zip(_leaf_names(p32), g32))
        del p32, g32
        p16 = init_dit_params(cfg, device="cuda", dtype=torch.bfloat16, seed=40)
        _, g16 = _grads(p16, batch, draws, cfg, "auto")
        ref16 = dict(zip(_leaf_names(p16), g16))
        _, g16 = _grads(p16, batch, draws, cfg, "xla")
        spread16 = {n: rel_l2(g, ref16[n])
                    for n, g in zip(_leaf_names(p16), g16) if g is not None}
        del p16, g16
        torch.cuda.empty_cache()
    out = {}
    # seq2: seq = 2 on the all-gathered KV (FlashAttentionFunction, which
    # rounds as the unsharded path does); seq2_ring: the same mesh through
    # ring attention (kernel 3 on each half of the keys, merged).
    for mode in ("tensor2", "data2", "gpipe2", "seq2", "seq2_ring"):
        params = init_dit_params(cfg, device="cuda", dtype=torch.bfloat16, seed=40)
        shardings = None
        if mode == "gpipe2":
            mesh = make_pp_mesh(2)
            params["blocks"] = pp_block_shardings(mesh)(params["blocks"])
            kw = {"block_executor": make_pp_executor(mesh, 2)}
        else:
            mesh = make_mesh(2, data=2 if mode == "data2" else 1,
                             seq=2 if mode.startswith("seq2") else 1,
                             tensor=2 if mode == "tensor2" else 1)
            shardings = dit_param_shardings(params, mesh)
            params = shard_params(params, shardings)
            kw = {"seq_sharding_constraint": token_sharding_constraint(mesh)}
            if mode == "seq2_ring":
                kw["attn_backend"] = "ring"
        torch.cuda.empty_cache()
        for p in leaves(params):
            if p is not None:
                p.requires_grad_(True)
        fa.reset_counts()
        t0 = time.perf_counter()
        loss = edm_loss(params, *batch.values(), None, cfg, condition_drop_rate=0.1,
                        draws=draws, **kw)
        loss.backward()
        torch.cuda.synchronize()
        rec = {"loss": loss.item(), "fwd_bwd_s_host_staged": time.perf_counter() - t0,
               "kernel3_launches": fa.VARIANT_LAUNCHES["flash_attention_partial"],
               "weights_gib": _weights_gib(params)}
        grads = _gather_whole(tree_map(lambda p: p.grad, params), mode, mesh, shardings,
                              cfg.num_blocks)
        for p in leaves(params):
            if p is not None:
                p.grad = None
                p.requires_grad_(False)
        if rank == 0:
            flat = flatten(grads, "params")
            missing = [n for n, g in flat.items() if g is None and not (
                "/ca/" in n and n.split("/")[-1] in UNUSED_CA)]
            check(not missing, f"{mode}: leaves without a gradient: {missing}")
            errs = {n: rel_l2(g, ref[n]) for n, g in flat.items() if g is not None}
            errs16 = {n: rel_l2(ref16[n], ref[n]) for n in errs}
            same = {n: rel_l2(g, ref16[n]) for n, g in flat.items() if g is not None}
            worst = max(errs, key=errs.get)
            # Where the unsharded bf16 kernel path is itself past the bound
            # from fp32 (the q / k side of the deeper blocks), the sharded
            # gradient is held to that path instead.
            beyond = sorted(n for n in errs if errs16[n] > TRAIN_DIT_GRAD_TOL)
            rec.update(leaves_with_gradient=len(errs), worst_leaf=worst,
                       worst_rel_l2=errs[worst], unsharded_bf16_at_worst=errs16[worst],
                       vs_unsharded_bf16_worst_rel_l2=max(same.values()),
                       norm_leaves_rel_l2=max(e for n, e in errs.items()
                                              if n.endswith(("q_norm", "k_norm"))),
                       unsharded_bf16_beyond_bound=len(beyond),
                       worst_where_bound_holds=max(
                           (errs[n] for n in errs if n not in beyond), default=0.0),
                       vs_unsharded_bf16_where_bound_holds=max(
                           (same[n] for n in errs if n not in beyond), default=0.0))
            if beyond:
                rec.update(
                    beyond_vs_fp32_minus_unsharded_bf16_max=max(errs[n] - errs16[n]
                                                                for n in beyond),
                    beyond_unsharded_bf16_plain_vs_kernel_max=max(spread16[n] for n in beyond))
            bad = []
            for n in errs:
                if mode == "seq2_ring" and n in beyond:
                    # The ring rounds apart from the unsharded kernel path
                    # (kernel 3 on each half of the keys, the halves'
                    # bf16 outputs merged), so where that path is itself
                    # past the bound, the two differ as the unsharded bf16
                    # plain path and kernel path do (rec above): the ring
                    # is held to fp32 instead, no further from it than the
                    # unsharded bf16 path by more than the bound.
                    ok = errs[n] <= errs16[n] + TRAIN_DIT_GRAD_TOL
                else:
                    ok = same[n] <= TRAIN_DIT_GRAD_TOL and (
                        n in beyond or errs[n] <= TRAIN_DIT_GRAD_TOL)
                if not (ok and math.isfinite(errs[n])):
                    bad.append(f"leaf {n} gradient {errs[n]:.3g} from fp32 (the unsharded bf16 "
                               f"kernel path {errs16[n]:.3g}), {same[n]:.3g} from that path")
            if bad:
                say(f"  [rank {rank}] multirank_train_{mode} " + json.dumps(rec))
            check(not bad, f"{mode} (bound {TRAIN_DIT_GRAD_TOL}): " + "; ".join(bad[:4]))
        if mode == "seq2_ring":
            want = 2 * cfg.num_blocks  # two hops a block forward, none backward
            check(rec["kernel3_launches"] == want,
                  f"seq2_ring: {rec['kernel3_launches']} kernel-3 launches, expected {want}")
        del grads
        opt = make_optimizer(1e-4)
        step = (ring_train_step(cfg, opt, mesh) if mode == "seq2_ring"
                else make_train_step(cfg, opt, condition_drop_rate=0.1, **kw))
        state = init_train_state(params, opt)
        fa.reset_counts()
        t0 = time.perf_counter()
        state, step_loss = step(state, batch, draws=[draws])
        torch.cuda.synchronize()
        rec["step_s_host_staged"] = time.perf_counter() - t0
        rec["step_kernel3_launches"] = fa.VARIANT_LAUNCHES["flash_attention_partial"]
        rec["step_loss"] = float(step_loss)
        check(math.isfinite(rec["step_loss"]) and state.step == 1,
              f"{mode}: train step loss {rec['step_loss']}")
        say(f"  [rank {rank}] multirank_train_{mode} " + json.dumps(rec))
        out[mode] = rec
        del params, state, step
        torch.cuda.empty_cache()
    return out


def _crossattn_tp_part(rank, x, sigma, cond, net):
    """Phase 32 (d): a full-width bf16 forward with a 512-token crossattn_emb
    at tensor = 2, (1, 1, 2), the cross-attention's q / k / v column-parallel
    and its out row-parallel, against rank 0's unsharded forward through the
    same attention branch (kernel 2, online: the mesh's)."""
    import torch
    from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
    from diffusionrenderer_tpu_torch.parallel import (dit_param_shardings, make_mesh,
                                                      shard_params, token_sharding_constraint)

    mesh = make_mesh(2, data=1, seq=1, tensor=2)
    emb = crossattn_context(x.shape[0])
    ref = None
    if rank == 0:
        full = init_dit_params(net, device="cuda", dtype=torch.bfloat16, seed=0)
        with torch.no_grad():
            ref = dit_forward(full, x, sigma, cond, None, net, crossattn_emb=emb,
                              attn_backend="pallas_onlinemax")
        params = shard_params(full, dit_param_shardings(full, mesh))
        del full
    else:
        params = init_dit_params(net, device="cuda", dtype=torch.bfloat16, seed=0,
                                 block_fn=lambda bp: _shard_block(bp, mesh))
    torch.cuda.empty_cache()
    ca = params["blocks"][0]["ca"]
    rec = {"mesh": (1, 1, 2), "crossattn_emb": list(emb.shape),
           "ca_shard_shapes": {k: list(ca[k].shape) for k in ("wq", "wk", "wv", "wo")}}
    t0 = time.perf_counter()
    with torch.no_grad():
        got = dit_forward(params, x, sigma, cond, None, net, crossattn_emb=emb,
                          seq_sharding_constraint=token_sharding_constraint(mesh))
        torch.cuda.synchronize()
    rec["forward_s_host_staged"] = time.perf_counter() - t0
    d, ctx_ch = net.model_channels, net.crossattn_emb_channels
    check(rec["ca_shard_shapes"] == {"wq": [d // 2, d], "wk": [d // 2, ctx_ch],
                                     "wv": [d // 2, ctx_ch], "wo": [d, d // 2]},
          f"rank {rank}: cross-attention shards {rec['ca_shard_shapes']}")
    check(bool(torch.isfinite(got).all()), f"rank {rank}: crossattn forward not finite")
    if rank == 0:
        rec["vs_unsharded_rel_l2"] = rel_l2(got, ref)
        rec["bound"] = MULTI_FWD_TOL
        check(rec["vs_unsharded_rel_l2"] <= MULTI_FWD_TOL,
              f"crossattn_emb at tensor = 2: {rec['vs_unsharded_rel_l2']:.3g} from the "
              f"unsharded forward (bound {MULTI_FWD_TOL})")
    say(f"  [rank {rank}] multirank_crossattn " + json.dumps(rec))
    del params, got, ref
    torch.cuda.empty_cache()
    return rec


def _cde_rank(rank, world, _):
    """(c), (d) and (e) on two ranks (ring attention's gradient first), and
    phase 32 (d)."""
    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config

    net = get_inverse_renderer_config(512, 512, 1).net
    x, sigma, cond, ctx = dit_inputs(6)
    rec = {"w8a8": _w8a8_tp_part(rank, x, sigma, cond, ctx, net),
           "ring_attention": _ring_attention_part(rank)}
    rec["crossattn"] = _crossattn_tp_part(rank, x, sigma, cond, net)
    rec["gpipe"] = _gpipe_part(rank, x, sigma, cond, ctx, net)
    say(f"  [rank {rank}] multirank_gpipe " + json.dumps(rec["gpipe"]))
    rec["train"] = _train_part(rank, net)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rec


MULTI_PARTS = {"probe": _probe_rank, "render": _render_rank, "cde": _cde_rank}


def _rank_main(rank, world, port, part, arg):
    """One rank of a phase-31 part: a gloo process group on the card
    (chosen here: NCCL takes one rank per card), the part, its record."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from diffusionrenderer_tpu_torch.parallel import initialize_distributed

    initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                           world_size=world, rank=rank)
    try:
        rec = MULTI_PARTS[part](rank, world, arg)
        with open(os.path.join(MULTI_DIR, f"{part}.{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _spawn(part, world, arg=None):
    """Start `world` ranks (spawned interpreters) and join each with its own
    timeout; returns their exit codes (None: killed after the timeout)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, part, arg))
             for r in range(world)]
    for p in procs:
        p.start()
    codes = []
    try:
        for p in procs:
            p.join(MULTI_RANK_TIMEOUT_S)
            codes.append(None if p.is_alive() else p.exitcode)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    return codes


def _run_part(part, world):
    codes = _spawn(part, world)
    check(all(c == 0 for c in codes),
          f"phase 31 {part}: rank exit codes {codes} (None: hung past {MULTI_RANK_TIMEOUT_S} s)")
    recs = []
    for r in range(world):
        with open(os.path.join(MULTI_DIR, f"{part}.{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def probe_part():
    """(a) Which collectives gloo takes on the card's CUDA tensors."""
    total = len(PROBE_OPS) * len(PROBE_DTYPES)
    path = os.path.join(MULTI_DIR, "probe.jsonl")
    done = 0
    while done < total:
        codes = _spawn("probe", 2, done)
        lines = open(path).read().splitlines() if os.path.exists(path) else []
        if len(lines) == done:  # the case at `done` took its ranks down
            op, dn = [(o, d) for o in PROBE_OPS for d in PROBE_DTYPES][done]
            with open(path, "a") as f:
                f.write(json.dumps({"op": op, "dtype": dn,
                                    "result": f"refused: a rank exited with {codes}"}) + "\n")
        done = len(open(path).read().splitlines())
    res = {}
    for line in open(path).read().splitlines():
        r = json.loads(line)
        res.setdefault(r["op"], {})[r["dtype"]] = r["result"]
    return res


def tp_kernel_records():
    """Kernel 4 at the tensor = 2 shard shapes (per channel and g128) and
    kernel 2 at the per-rank attention shapes, against their plain versions,
    timed (in this process, on the card alone) beside their bounds and
    library calls."""
    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa

    qmm = [qmm_case(m, k, n, g, seed=310 + i, timed=True)
           for i, (m, k, n) in enumerate(QMM_TP_SHAPES) for g in (None, 128)]
    attn = []
    for i, shape in enumerate(ATTN_TP_SHAPES):
        q, k, v = make_qkv(shape, rms_normed=True, seed=320 + i)
        fa.reset_counts()
        got = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention"]
        want = fa.flash_attention_plain(q, k, v, bounded=False)
        err, rel, ok = compare(got, want)
        rec = {"shape": list(shape), "launches": launches, "max_abs_err": err, "rel_l2": rel,
               "ms": time_ms(lambda: fa.flash_attention(q, k, v), 20),
               "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, bounded=False),
                                   3, 1),
               "library_ms": sdpa_ms(q, k, v, 20),
               "library": "F.scaled_dot_product_attention bf16"}
        rec["bound_ms"], rec["bound_by"] = attention_bound(shape, noshift=False)
        say("  kernel 2 per-rank " + json.dumps(rec))
        check(launches == 1 and ok, f"kernel 2 at {shape}: launches {launches}, err {err:.3g} "
                                    f"rel {rel:.3g}")
        attn.append(rec)
    return qmm, attn


def multi_rank_phase(card: str):
    """Phase 31: the multi-device path in several processes on the one card,
    over gloo (module docstring)."""
    import shutil

    import torch

    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    os.makedirs(MULTI_DIR)
    torch.cuda.empty_cache()
    rec = {"card": card, "timing": HOST_STAGED,
           "nccl_world_size_above_1": "not run: phase 31's ranks share one card, and NCCL "
                                      "takes one rank per card"}
    try:
        t = time.perf_counter()
        rec["probe"] = probe_part()
        say("multirank_probe " + json.dumps(rec["probe"]))
        refused = [(op, dn) for op in PORT_OPS for dn in PROBE_DTYPES
                   if rec["probe"][op][dn] != "ok"]
        check(not refused, f"gloo refused collectives the port calls: {refused}")
        say(f"  (a) probe: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        rec["render"] = _run_part("render", 4)
        say(f"  (b) default mesh render: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        cde = _run_part("cde", 2)
        rec["w8a8"] = [r["w8a8"] for r in cde]
        rec["gpipe"] = [r["gpipe"] for r in cde]
        rec["train"] = [r["train"] for r in cde]
        rec["ring_attention"] = [r["ring_attention"] for r in cde]
        rec["crossattn"] = [r["crossattn"] for r in cde]
        rec["cde_peak_gib"] = [r["peak_gib"] for r in cde]
        say(f"  (c)-(e) W8A8, ring attention's gradient, GPipe, train steps: "
            f"{time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(MULTI_DIR, ignore_errors=True)
    rec["qmm_tp"], rec["attention_tp"] = tp_kernel_records()
    r0 = rec["render"][0]
    say("multirank " + json.dumps({
        "card": card, "timing": HOST_STAGED,
        "nccl_world_size_above_1": rec["nccl_world_size_above_1"],
        "render": {k: r0[k] for k in ("dit_weights_gib", "load_peak_gib", "render_peak_gib",
                                      "inverse_render_wall_s_host_staged",
                                      "forward_vs_unsharded_rel_l2",
                                      "forward_vs_unsharded_online_rel_l2")},
        "render_launches_per_rank": [r["launches"] for r in rec["render"]],
        "w8a8": {label: {k: v for k, v in rec["w8a8"][0][label].items()
                         if k != "shard_shapes_mkn"} for label in ("w8a8", "w8a8_g128")},
        "gpipe": rec["gpipe"][0],
        "train": {mode: {k: rec["train"][0][mode][k] for k in (
            "worst_leaf", "worst_rel_l2", "unsharded_bf16_at_worst",
            "vs_unsharded_bf16_worst_rel_l2", "unsharded_bf16_beyond_bound",
            "worst_where_bound_holds", "vs_unsharded_bf16_where_bound_holds",
            "norm_leaves_rel_l2", "kernel3_launches", "step_kernel3_launches",
            "fwd_bwd_s_host_staged", "step_s_host_staged")}
            | {k: v for k, v in rec["train"][0][mode].items() if k.startswith("beyond_")}
            for mode in rec["train"][0]},
        "ring_attention": rec["ring_attention"][0],
        "cde_peak_gib": rec["cde_peak_gib"]}))
    return rec


# ---------------------------------------------------------------------------
# Phase 32: an explicit cross-attention context at full width
# ---------------------------------------------------------------------------

# The text-embedding context a Cosmos DiT's cross-attention takes: 512
# tokens of crossattn_emb_channels (1024).
CROSSATTN_TOKENS = 512


def crossattn_context(rows: int, m: int = CROSSATTN_TOKENS, seed: int = 32):
    """A seeded bf16 (rows, m, 1024) crossattn_emb on the card."""
    import torch
    from diffusionrenderer_tpu_torch.config import DiTConfig

    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(rows, m, DiTConfig().crossattn_emb_channels, generator=g,
                       device="cuda").bfloat16()


def crossattn_phase(multi):
    """dit_forward(crossattn_emb=) on the FADITV2_7B inverse DiT with
    load_pipeline()'s seeded weights (phase 7's), at phase 7's shape:
    (a) a one-token context of the table's rows bitwise the context_index
    forward; (b) a 512-token context through the kernels against the plain
    attention path (phase 8's bound), the launches of kernels 1 / 2 and the
    headroom kernel, and both forwards' times; (c) W8A8 (per channel) with
    the 512-token context: kernel 4's launches, the forward against its
    plain W8A8 version (phase 11's bound), kernel 4 at the cross-attention's
    (2560, 1024, 4096) per channel and g128; (d) phase 31's tensor = 2
    forward with the context, read from its ranks' records."""
    import torch
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models import quant
    from diffusionrenderer_tpu_torch.models.dit import dit_forward, init_dit_params
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm

    net = get_inverse_renderer_config(512, 512, 1).net
    params = init_dit_params(net, device="cuda", dtype=torch.bfloat16, seed=0)
    x, sigma, cond, idx = dit_inputs(32)
    rows = x.shape[0]
    emb = crossattn_context(rows)
    rec = {"shape": list(x.shape), "crossattn_emb": list(emb.shape)}

    def forward(p, ctx_index, e, backend="auto"):
        with torch.no_grad():
            return dit_forward(p, x, sigma, cond, ctx_index, net, crossattn_emb=e,
                               attn_backend=backend)

    # (a) The collapse: a (B, 1, C) context of the table's rows.
    one = params["context_embedding"]["weight"][idx.long()][:, None, :]
    a = {"bitwise": bool(torch.equal(forward(params, None, one), forward(params, idx, None))),
         "forward_ms": time_ms(lambda: forward(params, idx, None), 3)}
    check(a["bitwise"], "crossattn_emb of the table's rows differs from the context_index forward")
    rec["a_one_token"] = a

    # (b) The general path at M = 512.
    fa.reset_counts()
    got = forward(params, None, emb)
    torch.cuda.synchronize()
    b = {"launches": dict(fa.LAUNCHES), "vs_plain_attention_rel_l2": rel_l2(
        got, forward(params, None, emb, "xla")), "bound": 3e-2,
         "forward_ms": time_ms(lambda: forward(params, None, emb), 3),
         "forward_ms_one_token": a["forward_ms"], "finite": bool(torch.isfinite(got).all())}
    b["added_ms"] = b["forward_ms"] - a["forward_ms"]
    # Where the added time goes (the plain fp32-softmax cross-attention is
    # cuBLAS fp32 products and elementwise kernels).
    b["profile"] = profile_phase(params, "crossattn_512", inputs=(x, sigma, cond, None),
                                 crossattn_emb=emb)
    rec["b_general"] = b
    for name in ("flash_attention", "flash_attention_headroom"):
        check(b["launches"][name] == net.num_blocks,
              f"crossattn forward: {b['launches'][name]} {name} launches, "
              f"expected {net.num_blocks}")
    check(b["finite"] and b["vs_plain_attention_rel_l2"] <= b["bound"],
          f"crossattn forward: kernel path {b['vs_plain_attention_rel_l2']:.3g} from plain")
    del got

    # (c) W8A8 per channel: ca.wq / wk / wv / wo cross 512 rows too.
    qparams = quant.quantize_dit_params(params, act_quant=True)
    del params
    torch.cuda.empty_cache()

    def plain_w8a8(xx, wq, scale):
        *lead, k = xx.shape
        xq, dq = qm.quantize_activation_fp32(xx.reshape(-1, k))
        return qm.quant_matmul_w8a8_plain(xq, dq, wq, scale, xx.dtype).reshape(*lead, -1)

    counts = {}
    for label, ctx_index, e in (("one_token", idx, None), ("crossattn", None, emb)):
        qm.reset_counts()
        out = forward(qparams, ctx_index, e)
        torch.cuda.synchronize()
        counts[label] = qm.LAUNCHES["quant_matmul_w8a8"]
    kernel_call, quant.quant_matmul_w8a8 = quant.quant_matmul_w8a8, plain_w8a8
    try:
        want = forward(qparams, None, emb)
    finally:
        quant.quant_matmul_w8a8 = kernel_call
    c = {"launches_one_token": counts["one_token"], "launches_crossattn": counts["crossattn"],
         "expected": (6 * net.num_blocks, 10 * net.num_blocks),
         "vs_plain_w8a8_rel_l2": rel_l2(out, want), "bound": 2e-2,
         "forward_ms": time_ms(lambda: forward(qparams, None, emb), 3),
         "kernel4": [qmm_case(rows * CROSSATTN_TOKENS, net.crossattn_emb_channels,
                              net.model_channels, g_, seed=330 + i, timed=True)
                     for i, g_ in enumerate((None, 128))]}
    rec["c_w8a8"] = c
    check((c["launches_one_token"], c["launches_crossattn"]) == c["expected"],
          f"W8A8 crossattn forward: kernel-4 launches {c['launches_one_token']} / "
          f"{c['launches_crossattn']}, expected {c['expected']}")
    check(bool(torch.isfinite(out).all()) and c["vs_plain_w8a8_rel_l2"] <= c["bound"],
          f"W8A8 crossattn forward: {c['vs_plain_w8a8_rel_l2']:.3g} from its plain version")
    del qparams, out, want
    torch.cuda.empty_cache()

    # (d) Phase 31's ranks at tensor = 2.
    rec["d_tensor2"] = multi["crossattn"][0]
    say("crossattn " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# Phases 33 and 34: the compiled denoise step and the compiled VAE against
# their eager counterparts; phase 35: the compiled train step
# ---------------------------------------------------------------------------

# Warm calls of each render, graph and eager in turns (phases 33 and 34).
COMPILED_WARM = 3


def graph_pool_gib(graph) -> float:
    """The device memory a captured graph's private pool holds (with a
    shared pool, all its graphs')."""
    import torch

    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool) / GIB


class timed_captures:
    """Within the block, every pipeline._GraphRunner.capture is closed by a
    synchronize on both sides and recorded in `self.records` as {"runner":
    'step' | 'encode' | 'decode' | 'train', "capture_s", "pool_gib"}."""

    def __init__(self):
        self.records = []

    def __enter__(self):
        import torch
        from diffusionrenderer_tpu_torch import pipeline as tp

        self._real = real = tp._GraphRunner.capture
        records = self.records

        def capture(runner, key, fn, inputs, extra=None, since=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry = real(runner, key, fn, inputs, extra, since)
            torch.cuda.synchronize()
            kind = ("step" if isinstance(runner, tp._StepGraphs) else key[0]
                    if isinstance(runner, tp._VaeGraphs) else "train")
            records.append({"runner": kind, "capture_s": time.perf_counter() - t0,
                            "pool_gib": graph_pool_gib(entry.graph)})
            return entry

        tp._GraphRunner.capture = capture
        return self

    def __exit__(self, *exc):
        from diffusionrenderer_tpu_torch import pipeline as tp

        tp._GraphRunner.capture = self._real
        return False

    def count(self, kind: str) -> int:
        return sum(r["runner"] == kind for r in self.records)

    def last(self, kind: str) -> dict:
        return [r for r in self.records if r["runner"] == kind][-1]


def step_idle(run) -> dict:
    """torch.profiler over run(), one Euler step closed by a synchronize:
    the device time of its kernels, copies and memsets, the wall time and
    the device's idle share; and the CUDA-event span from before the step's
    first launch to after its last."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    kernels = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Command Buffer"):
            continue
        busy += (ev.self_device_time_total if hasattr(ev, "self_device_time_total")
                 else ev.self_cuda_time_total) / 1e3
        kernels += ev.count
    return {"wall_ms": wall_ms, "device_ms": busy, "device_events": kernels,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "event_span_ms": start.elapsed_time(end)}


def compiled_renders_phase(env_path: str, hook: str):
    """Five renders at full width, each on a fresh pipeline so that its first
    call captures: inverse_render in bf16, w8a8 and w8a8_g128 (5 passes
    batched), forward_render with one frame, and one inverse pass at
    guidance 1.0, then reused at 2.0 (the same graphs, the guidance
    refilled).  Each render as it runs by default (every graph replayed)
    against the same render with the pipeline's `hook` set: '_eager_denoise'
    (phase 33: the eager Euler loop) or '_eager_vae' (phase 34: the eager
    encode and decode, the denoise replayed in both).  The outputs and the
    final latents bitwise, the launches and the branch tally equal; the
    captures' seconds and pools, the render's peaks; COMPILED_WARM warm calls
    of each, in turns, with the encode / denoise / decode seconds of each;
    for phase 33 the idle share of one replayed and one eager step under
    torch.profiler."""
    import gc

    import numpy as np
    import torch
    from diffusionrenderer_tpu_torch import forward_render, inverse_render, load_hdr, load_pipeline
    from diffusionrenderer_tpu_torch import pipeline as tp
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.ops import quant_matmul as qm

    phase_name = {"_eager_denoise": "compiled_denoise", "_eager_vae": "compiled_vae"}[hook]
    compiled = "step" if hook == "_eager_denoise" else None  # the runner under test
    latents = []
    real_graph_decode, real_decode = tp._VaeGraphs.decode, tp.decode

    def keep_latent(decode):
        """decode, recording the latent it is given (the eager decode's and
        the decode graph's, whose replays call no decode), but not inside a
        capture, where the latent is a static buffer's."""
        def call(*args, **kwargs):
            if not torch.cuda.is_current_stream_capturing():
                sample_ = args[2] if isinstance(args[0], tp._VaeGraphs) else args[1]
                latents.append(sample_.clone())
            return decode(*args, **kwargs)
        return call

    def counted(pipe, call, eager: bool):
        setattr(pipe, hook, eager)
        latents.clear()
        fa.reset_counts()
        qm.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = call()
            torch.cuda.synchronize()
        finally:
            setattr(pipe, hook, False)
        return {"out": out, "latent": latents[-1], "wall_s": time.perf_counter() - t0,
                "step_ms": pipe.timings["denoise"] / pipe.num_steps * 1e3,
                "encode_s": pipe.timings["encode"], "decode_s": pipe.timings["decode"],
                "peak_gib": torch.cuda.max_memory_allocated() / GIB,
                "peak_reserved_gib": torch.cuda.max_memory_reserved() / GIB,
                "launches": {**fa.LAUNCHES, **fa.VARIANT_LAUNCHES, **qm.LAUNCHES},
                "branches": fa.branch_counts("cuda")}

    def same(label, want, got):
        """got's outputs and latents bitwise want's, its launches and tally equal."""
        outs = want["out"].items() if isinstance(want["out"], dict) else [("out", want["out"])]
        for name, arr in outs:
            other = got["out"][name] if isinstance(got["out"], dict) else got["out"]
            check(np.array_equal(arr, other), f"{label}: output {name} differs")
        check(torch.equal(want["latent"], got["latent"]), f"{label}: final latents differ")
        check(want["launches"] == got["launches"] and want["branches"] == got["branches"],
              f"{label}: launches {got['launches']} {got['branches']} != "
              f"{want['launches']} {want['branches']}")

    def quartiles(xs):
        return dict(zip(("q1", "median", "q3"), statistics.quantiles(xs, n=4,
                                                                    method="inclusive")))

    def one_render(label, pipe, call, expected, expected_qmm=0):
        n_cap = len(caps.records)
        first = counted(pipe, call, eager=False)
        new = caps.records[n_cap:]
        kinds = [r["runner"] for r in new]
        check(set(kinds) == {"encode", "step", "decode"} and kinds.count("step") == 1
              and kinds.count("decode") == 1,
              f"{label}: the first call captured {kinds}, not encode graphs, one step and "
              f"one decode graph")
        launches = first["launches"]
        for name in ("flash_attention", "flash_attention_headroom"):
            check(launches[name] == expected,
                  f"{label}: {name} {launches[name]} launches, expected {expected}")
        check(launches["quant_matmul_w8a8"] == expected_qmm,
              f"{label}: {launches['quant_matmul_w8a8']} W8A8 launches, expected {expected_qmm}")
        check(first["branches"]["noshift"] + first["branches"]["online"] == expected,
              f"{label}: branch tally {first['branches']}")
        # Warm calls in turns, eager first in every other pair; each one,
        # eager or replayed, bitwise the first (capturing) call.
        runs = {"graph": [], "eager": []}
        for i in range(COMPILED_WARM):
            for mode in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
                rec = counted(pipe, call, eager=mode == "eager")
                same(f"{label} {mode} {i}", first, rec)
                runs[mode].append(rec)
        check(len(caps.records) == n_cap + len(new), f"{label}: a warm call captured again")
        med = {key: {m: statistics.median(r[key] for r in rs) for m, rs in runs.items()}
               for key in ("step_ms", "encode_s", "decode_s")}
        walls = {m: [r["wall_s"] for r in rs] for m, rs in runs.items()}
        rec = {"render": label, "launches": launches, "branches": first["branches"],
               "bitwise_outputs_and_latents": True,
               "captures": [{k: r[k] for k in ("runner", "capture_s", "pool_gib")}
                            for r in new],
               "first_wall_s": first["wall_s"],
               "first_s": {k: first[k] for k in ("encode_s", "decode_s")},
               "peak_gib": {"first": first["peak_gib"],
                            **{m: max(r["peak_gib"] for r in rs) for m, rs in runs.items()}},
               "peak_reserved_gib": {"first": first["peak_reserved_gib"],
                                     **{m: max(r["peak_reserved_gib"] for r in rs)
                                        for m, rs in runs.items()}},
               "warm_wall_s": walls,
               "warm_wall_quartiles_s": {m: quartiles(w) for m, w in walls.items()},
               "warm_step_ms": {m: [r["step_ms"] for r in rs] for m, rs in runs.items()},
               "warm_step_ms_median": med["step_ms"],
               "warm_encode_s_median": med["encode_s"], "warm_decode_s_median": med["decode_s"]}
        if compiled == "step":
            entry = list(pipe._step_graphs._graphs.values())[-1]
            cfg = pipe._config_for((1, 1, 512, 512, 3))  # every render here: one 512x512 frame
            step = tp._make_edm_scan_step(
                tp._denoise_fn(pipe.dit_params, *entry.inputs[2:], cfg=cfg,
                               mlp_token_chunks=tp.resolve_mlp_token_chunks(
                                   cfg, pipe.mlp_token_chunks)),
                cfg.scheduler.sigma_data)
            with torch.inference_mode():
                rec["replayed_step"] = step_idle(entry.graph.replay)
                rec["eager_step"] = step_idle(lambda: step(entry.inputs[0], entry.inputs[1]))
        say(f"{phase_name}_{label} " + json.dumps(rec))
        return rec

    def fresh(**kw):
        gc.collect()
        torch.cuda.empty_cache()
        return load_pipeline(**kw)

    res = {}
    tp._VaeGraphs.decode = keep_latent(real_graph_decode)
    tp.decode = keep_latent(real_decode)
    try:
        with timed_captures() as caps:
            image = np.random.default_rng(33).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
            for label, kw in (("inverse_bf16", {}),
                              ("inverse_w8a8", dict(quantize_int8=True, act_quant=True)),
                              ("inverse_w8a8_g128", dict(quantize_int8=True, act_quant=True,
                                                         quant_group_size=128))):
                pipe = fresh(**kw)
                forward_calls = pipe.num_steps * len(pipe.dit_params["blocks"])
                res[label] = one_render(label, pipe, lambda: inverse_render(pipe, image),
                                        forward_calls + 2, 6 * forward_calls if kw else 0)
                del pipe
            fwd = fresh(model_type="forward")
            env = load_hdr(env_path)
            gbuf = forward_gbuffers(1, seed=33)
            res["forward_1_frame"] = one_render(
                "forward_1_frame", fwd,
                lambda: forward_render(fwd, *gbuf, env, env_format="proj"),
                fwd.num_steps * len(fwd.dit_params["blocks"]) + 8 + 1)
            del fwd
            pipe = fresh()
            res["guidance_1.0"] = one_render(
                "guidance_1.0", pipe,
                lambda: inverse_render(pipe, image, guidance=1.0, passes=("basecolor",)),
                pipe.num_steps * len(pipe.dit_params["blocks"]) + 2)
            # The same graphs at guidance 2.0: refilled, not captured again.
            n_cap = len(caps.records)

            def call():
                return inverse_render(pipe, image, guidance=2.0, passes=("basecolor",))

            got, want = counted(pipe, call, eager=False), counted(pipe, call, eager=True)
            same("guidance 2.0 reuse", got, want)
            check(len(caps.records) == n_cap, "guidance 2.0 captured a second graph")
            res["guidance_2.0_reuse"] = {"bitwise_outputs_and_latents": True,
                                         "launches": got["launches"],
                                         "wall_s": {"graph": got["wall_s"],
                                                    "eager": want["wall_s"]}}
            say(f"{phase_name}_guidance_2.0_reuse " + json.dumps(res["guidance_2.0_reuse"]))
            del pipe
    finally:
        tp._VaeGraphs.decode, tp.decode = real_graph_decode, real_decode
    gc.collect()
    torch.cuda.empty_cache()
    return res


def leaf_digests(tensors):
    """Two int64 sums of each tensor's bit patterns (plain and position
    weighted), a cheap bitwise fingerprint computed on the card."""
    import torch

    out = []
    for t in tensors:
        bits = t.detach().contiguous().view(-1).view(
            {2: torch.int16, 4: torch.int32}[t.element_size()]).to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append((int(bits.sum()), int((bits * weight).sum())))
    return out


# Phase 35's run: (batch, grad_accum) of each step, phase 30(c)'s.
TRAIN_GRAPH_RUN = ((1, 1), (1, 1), (1, 1), (2, 2), (2, 2))


def compiled_train_phase(seed: int = 34):
    """Phase 30(c)'s FADITV2_7B weights (load_pipeline()'s) and VAE-encoded
    latents, 3 steps at batch 1 and 2 at batch 2 with grad_accum=2 and
    condition dropout 0.1, from the same fresh state twice (two 7B states
    do not fit the card): eager (the step's _eager hook), then replayed (the
    default).  The losses bitwise, every parameter and both moments bitwise
    (per-leaf digests), 28 kernel-3 launches per microbatch; the step
    walls, each key's allocated and reserved peaks, the captures' seconds
    and the shared pool; one more replayed step under torch.profiler."""
    import gc

    import torch
    from diffusionrenderer_tpu_torch.ops import flash_attention as fa
    from diffusionrenderer_tpu_torch.training import (init_train_state, make_optimizer,
                                                      make_train_step)
    from diffusionrenderer_tpu_torch.training.loop import step_generator
    from diffusionrenderer_tpu_torch.utils.tree import leaves as tree_leaves

    cfg, params, lat, setup_s = train_7b_setup(seed)
    host = [p.to("cpu", copy=True) for p in tree_leaves(params)]
    runs = {}
    for mode in ("eager", "graph"):
        for p, h in zip(tree_leaves(params), host):
            p.copy_(h)
        opt = make_optimizer(TRAIN_LR)  # it holds the step graphs: new for each turn
        state = init_train_state(params, opt)
        steps = {a: make_train_step(cfg, opt, condition_drop_rate=0.1, grad_accum=a)
                 for a in (1, 2)}
        for s_ in steps.values():
            s_._eager = mode == "eager"
        rec = {"steps": [], "peaks": {}}
        with timed_captures() as caps:
            for i, (batch, accum) in enumerate(TRAIN_GRAPH_RUN):
                inputs = _train_inputs(batch, i, lat)
                torch.cuda.synchronize()
                if i == 0 or TRAIN_GRAPH_RUN[i - 1] != (batch, accum):
                    torch.cuda.reset_peak_memory_stats()
                fa.reset_counts()
                t = time.perf_counter()
                state, loss = steps[accum](state, inputs, step_generator(seed, i))
                torch.cuda.synchronize()
                rec["steps"].append({"batch": batch, "grad_accum": accum, "loss": loss,
                                     "wall_s": time.perf_counter() - t,
                                     "kernel3_launches":
                                         fa.VARIANT_LAUNCHES["flash_attention_partial"]})
                rec["peaks"][f"batch{batch}_accum{accum}"] = {
                    "allocated_gib": torch.cuda.max_memory_allocated() / GIB,
                    "reserved_gib": torch.cuda.max_memory_reserved() / GIB}
            rec["digests"] = leaf_digests(tree_leaves([state.params, state.opt_state.mu,
                                                       state.opt_state.nu]))
            rec["captures"] = caps.records
            if mode == "graph":
                inputs, gen = _train_inputs(1, 5, lat), step_generator(seed, 5)
                entry = next(iter(steps[1]._graphs._graphs.values()))
                fa.reset_counts()
                rec["replayed_step"] = step_idle(lambda: steps[1](state, inputs, gen))
                check(fa.VARIANT_LAUNCHES["flash_attention_partial"] == 2 * cfg.num_blocks,
                      "replayed train steps under the profiler: kernel-3 launches")
                rec["pool_gib"] = graph_pool_gib(entry.graph)
        runs[mode] = rec
        del state, steps, caps, opt
        gc.collect()
        torch.cuda.empty_cache()
    del params, host
    gc.collect()
    torch.cuda.empty_cache()
    eager, graph = runs["eager"], runs["graph"]
    for i, (e, g) in enumerate(zip(eager["steps"], graph["steps"])):
        check(torch.equal(e["loss"], g["loss"]), f"train step {i + 1}: graph loss "
                                                 f"{float(g['loss'])} != eager {float(e['loss'])}")
        for r in (e, g):
            want = cfg.num_blocks * r["grad_accum"]
            check(r["kernel3_launches"] == want,
                  f"train step {i + 1}: {r['kernel3_launches']} kernel-3 launches, "
                  f"expected {want} (28 per microbatch forward)")
    differ = [i for i, (a, b) in enumerate(zip(eager["digests"], graph["digests"])) if a != b]
    check(not differ, f"{len(differ)} parameter / moment leaves differ, first {differ[:8]}")
    check([r["runner"] for r in graph["captures"]] == ["train", "train"] and
          not eager["captures"], f"captures {graph['captures']} / {eager['captures']}")

    def warm(rec, accum):
        """The median wall of the steps of a key after its first (capturing)."""
        walls = [s_["wall_s"] for s_ in rec["steps"] if s_["grad_accum"] == accum]
        return statistics.median(walls[1:])

    out = {"config": "FADITV2_7B, bf16, 1 frame 512x512 latents", "setup_s": setup_s,
           "losses": [float(s_["loss"]) for s_ in graph["steps"]], "bitwise": True,
           "leaves_compared": len(graph["digests"]),
           "kernel3_launches": [s_["kernel3_launches"] for s_ in graph["steps"]],
           "step_wall_s": {m: [s_["wall_s"] for s_ in r["steps"]] for m, r in runs.items()},
           "warm_step_s_median": {m: {"batch1": warm(r, 1), "batch2_accum2": warm(r, 2)}
                                  for m, r in runs.items()},
           "peaks": {m: r["peaks"] for m, r in runs.items()},
           "captures": graph["captures"], "pool_gib": graph["pool_gib"],
           "replayed_step": graph["replayed_step"]}
    say("compiled_train " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# Phase 36: the DiT's fused norm chains
# ---------------------------------------------------------------------------

# Kernel 1 at its DiT call sites (the pending residuals: "full" (B, L, D),
# "row" (B, 1, D)) and whether it writes the modulated norm; per block the
# FA norm, the FA and one-token CA residuals with the MLP norm, and the MLP
# residual (the final layer's norm is the FA norm's shape once a forward).
FUSED_SITES = {"fa_norm": ((), True), "fa_ca_residuals_mlp_norm": (("full", "row"), True),
               "mlp_residual": (("full",), False)}
FUSED_TOKENS = {"inverse": (5, 1024), "forward": (1, 1024)}


def fused_site_inputs(b, l, site, d=4096, seed=36):
    import torch

    g = torch.Generator("cuda").manual_seed(seed)

    def r(*size, scale=1.0):
        return (torch.randn(*size, generator=g, device="cuda") * scale).bfloat16()

    residuals, norm = FUSED_SITES[site]
    pending = [(r(b, l if kind == "full" else 1, d), r(b, d, scale=0.3)) for kind in residuals]
    shift, scale = (r(b, d, scale=0.3), r(b, d, scale=0.3)) if norm else (None, None)
    return r(b, l, d, scale=2.0), pending, shift, scale


def fused_bound_ms(nbytes: int) -> float:
    return nbytes / PEAK_BYTES * 1e3


def fused_norms_phase(reps: int = 50):
    """Kernels 1 and 2 of csrc/dit_fused.cu at the inverse (5, 1024) and
    forward (1, 1024) token counts, D = 4096, 32 heads of 128: each launch
    against its plain chain (x' bitwise, the rest within the kernels'
    tolerance), its device ms (CUDA events, every launch queued behind a
    sleep kernel: the host's launch cost does not show), its byte bound
    (each activation read and each output written once at 3.35 TB/s; the
    (B, D) rows and tables counted too) and the plain chain's ms; then per
    DiT forward (28 blocks: 3 kernel-1 launches and 1 kernel-2 a block, the
    final norm)."""
    import torch

    from diffusionrenderer_tpu_torch.ops import dit_fused as tdf
    from diffusionrenderer_tpu_torch.ops.rope import rope_3d_angles

    rec = {}
    for label, (b, l) in FUSED_TOKENS.items():
        rows = {}
        for site in FUSED_SITES:
            x, pending, shift, scale = fused_site_inputs(b, l, site)
            got = tdf.residual_ln_modulate_kernel(x, pending, shift, scale)
            want = tdf.residual_ln_modulate_plain(x, pending, shift, scale)
            check(torch.equal(got[0], want[0]), f"{site} {label}: x' differs from the plain chain")
            if shift is not None:
                err, rel, ok = compare(got[1], want[1])
                check(ok, f"{site} {label}: xm against the plain chain {err:.3g} / {rel:.3g}")
            reads = [x, *(t for p in pending for t in p), shift, scale]
            writes = [got[0] if pending else None, got[1]]
            nbytes = sum(t.numel() * t.element_size() for t in reads + writes if t is not None)
            rows[site] = {
                "kernel_ms": queued_ms(lambda: tdf.residual_ln_modulate_kernel(
                    x, pending, shift, scale), reps),
                "bound_ms": fused_bound_ms(nbytes),
                "plain_ms": queued_ms(lambda: tdf.residual_ln_modulate_plain(
                    x, pending, shift, scale), reps)}
        g = torch.Generator("cuda").manual_seed(37)
        q, k = (torch.randn(b, l, 32, 128, generator=g, device="cuda").mul(3).bfloat16()
                for _ in range(2))
        wq, wk = ((1 + 0.1 * torch.randn(128, generator=g, device="cuda")).bfloat16()
                  for _ in range(2))
        angles = rope_3d_angles(1, 32, 32, 128, device="cuda")
        cos, sin = torch.cos(angles), torch.sin(angles)
        got = tdf.qk_rmsnorm_rope_kernel(q, k, wq, wk, cos, sin)
        want = tdf.qk_rmsnorm_rope_plain(q, k, wq, wk, cos, sin)
        for name, a, w in zip("qk", got, want):
            err, rel, ok = compare(a, w)
            check(ok, f"qk_rmsnorm_rope {label}: {name} against the plain chain "
                      f"{err:.3g} / {rel:.3g}")
        rows["qk_rmsnorm_rope"] = {
            "kernel_ms": queued_ms(lambda: tdf.qk_rmsnorm_rope_kernel(q, k, wq, wk, cos, sin),
                                   reps),
            "bound_ms": fused_bound_ms(4 * q.numel() * 2 + 2 * cos.numel() * 4),
            "plain_ms": queued_ms(lambda: tdf.qk_rmsnorm_rope_plain(q, k, wq, wk, cos, sin),
                                  reps)}
        for key in ("kernel_ms", "bound_ms", "plain_ms"):
            rows.setdefault("per_forward", {})[key] = (
                28 * sum(rows[s][key] for s in (*FUSED_SITES, "qk_rmsnorm_rope"))
                + rows["fa_norm"][key])
        for name, r in rows.items():
            say(f"  {label} {name}: kernel {r['kernel_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({100 * r['bound_ms'] / r['kernel_ms']:.1f}% of it), plain "
                f"{r['plain_ms']:.4f} ms")
        rec[label] = rows
    say("fused_norms " + json.dumps(rec))
    return rec


def main(argv) -> int:
    if argv not in ([], ["36"]):
        print("usage: python3 chip_smoke.py [36]  (36: phases 1, 2 and 36 alone)",
              file=sys.stderr)
        return 2
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
    card = device_phase()
    t = phase("2 build")
    occ = build_phase()
    if argv == ["36"]:
        t = phase("36 fused norm chains: kernels vs plain chains, timed")
        fused_norms_phase()
        say(f"  phase 36: {time.perf_counter() - t:.1f} s")
        say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0
    t = phase("3 kernels vs plain")
    errs = kernels_phase()
    say(f"  phase 3: {time.perf_counter() - t:.1f} s")
    t = phase("4 flagship attention")
    flagship_phase()
    flagship_vae = flagship_vae_phase()
    say(f"  phase 4: {time.perf_counter() - t:.1f} s")
    quant = {}
    t = phase("5 W8A8 matmul kernel vs plain")
    quant["qmm"] = qmm_phase()
    say(f"  phase 5: {time.perf_counter() - t:.1f} s")
    t = phase("6 int8 attention kernel vs plain")
    quant["fa8_max_err"], quant["fa8_timings"] = fa8_phase()
    say(f"  phase 6: {time.perf_counter() - t:.1f} s")
    t = phase("7 main path: load_pipeline + inverse_render")
    pipe, main_rec = main_path_phase(warm=1)
    say(f"  phase 7: {time.perf_counter() - t:.1f} s")
    t = phase("8 reference: kernel path vs plain attention path")
    reference_phase(pipe)
    say(f"  phase 8: {time.perf_counter() - t:.1f} s")
    t = phase("9 profile of one DiT forward at the main path's shape")
    profile_phase(pipe.dit_params)
    del pipe
    torch.cuda.empty_cache()
    say(f"  phase 9: {time.perf_counter() - t:.1f} s")
    t = phase("10 quantized main path: w8a8 and w8a8_g128")
    for label, kw in (("w8a8", {}), ("w8a8_g128", {"quant_group_size": 128})):
        pipe, quant[label] = main_path_phase(label, warm=1, quantize_int8=True, act_quant=True,
                                             **kw)
        del pipe
        torch.cuda.empty_cache()
    say(f"  phase 10: {time.perf_counter() - t:.1f} s")
    t = phase("11 quantized reference: W8A8 kernel path vs plain path")
    from diffusionrenderer_tpu_torch.config import get_inverse_renderer_config
    from diffusionrenderer_tpu_torch.models.dit import init_dit_params

    bf16_params = init_dit_params(get_inverse_renderer_config(512, 512, 1).net,
                                  device="cuda", dtype=torch.bfloat16, seed=0)
    w8a8_params, quant["reference"] = quant_reference_phase(bf16_params)
    from diffusionrenderer_tpu_torch.models.quant import quantize_dit_params

    g128_params = quantize_dit_params(bf16_params, act_quant=True, group_size=128)
    del bf16_params
    torch.cuda.empty_cache()
    say(f"  phase 11: {time.perf_counter() - t:.1f} s")
    t = phase("12 int8 attention path: dit_forward(attn_backend='pallas_pv_int8')")
    quant["int8_path"] = int8_attention_path_phase(w8a8_params)
    say(f"  phase 12: {time.perf_counter() - t:.1f} s")
    t = phase("13 profile of one W8A8 and one W8A8-g128 DiT forward")
    quant["profile"] = profile_phase(w8a8_params, "w8a8")
    quant["profile_g128"] = profile_phase(g128_params, "w8a8_g128")
    del g128_params
    quant["prepass_ms_per_forward"] = prepass_per_forward(quant["qmm"])
    say(f"  W8A8 activation pre-passes per DiT forward: {quant['prepass_ms_per_forward']:.2f} "
        "ms of device time (from phase 5's per-call times)")
    del w8a8_params
    torch.cuda.empty_cache()
    say(f"  phase 13: {time.perf_counter() - t:.1f} s")
    var = {}
    t = phase("14 kernels 3, 6 and 7 vs plain")
    var["max_err"], var["cases"] = variants_phase()
    say(f"  phase 14: {time.perf_counter() - t:.1f} s")
    t = phase("15 ring merge of kernel-3 shards on one card")
    var["ring_merge"] = ring_merge_phase()
    var["ring_merge_d512"] = ring_merge_phase(VAE_DEC_SHAPE, seed=66)
    say(f"  phase 15: {time.perf_counter() - t:.1f} s")
    t = phase("16 sharded main path: one-rank NCCL mesh, sp_attn='ring'")
    pipe, mesh, var["sharded"] = sharded_main_path_phase(main_rec["warm"]["median_s"], warm=5)
    var["sharded_forward"] = sharded_forward_phase(pipe, mesh)
    say(f"  phase 16: {time.perf_counter() - t:.1f} s")
    t = phase("17 bounded-shift DiT forwards: kernels 6 and 7")
    var["bounded_forward"] = bounded_forward_phase(pipe.dit_params)
    del pipe
    torch.cuda.empty_cache()
    import torch.distributed as dist

    dist.destroy_process_group()
    say(f"  phase 17: {time.perf_counter() - t:.1f} s")
    t = phase("18 timings of kernels 3, 6 and 7")
    var["timings"] = variant_timings_phase()
    say(f"  phase 18: {time.perf_counter() - t:.1f} s")
    t = phase("19 int8 attention kernel at head dims 512 and 256")
    wide = wide_int8_phase()
    say(f"  phase 19: {time.perf_counter() - t:.1f} s")
    t = phase("20 envmap: .hdr codec + load_hdr, projections on the card vs the CPU")
    env_path, _ = envmap_phase()
    say(f"  phase 20: {time.perf_counter() - t:.1f} s")
    t = phase("21 forward main path: load_pipeline(model_type='forward') + forward_render")
    pipe, fwd = forward_path_phase(env_path)
    say(f"  phase 21: {time.perf_counter() - t:.1f} s")
    t = phase("22 forward reference: kernel path vs plain attention path")
    forward_reference_phase(pipe)
    del pipe
    torch.cuda.empty_cache()
    say(f"  phase 22: {time.perf_counter() - t:.1f} s")
    t = phase("23 kernel timings at the main path's shapes")
    records = kernel_records(main_rec, errs, quant, var, occ, flagship_vae)
    for rec, name in zip(records[:3], ("flash_attention", "flash_attention",
                                       "flash_attention_headroom")):
        rec["launches_forward_render"] = fwd["first"]["launches"][name]
    for rec in records[:2]:
        rec["launches_by_branch_forward_render"] = fwd["first"]["branches"]
    records += wide_int8_records(wide, occ)
    say(f"  phase 23: {time.perf_counter() - t:.1f} s")
    t = phase("24 checkpoints: full-width DiT and VAE files through load_pipeline")
    pipe, ckpt = checkpoint_phase()
    say(f"  phase 24: {time.perf_counter() - t:.1f} s")
    t = phase("25 long video: 57 x 704 x 1280 inverse_render, decode in chunks of 4 latents")
    long_video = long_video_phase(pipe)
    say(f"  phase 25: {time.perf_counter() - t:.1f} s")
    t = phase("26 guidance 1.0 at 512 x 512")
    guidance_phase(pipe, main_rec["warm"]["median_step_ms"])
    del pipe
    torch.cuda.empty_cache()
    for rec in records[:3]:
        rec["launches_long_video"] = long_video["launches"][
            "flash_attention_headroom" if rec["name"] == "flash_attention_headroom"
            else "flash_attention"]
    records[3]["launches_checkpoint_w8a8_forward"] = ckpt["w8a8_forward_launches"]
    say(f"  phase 26: {time.perf_counter() - t:.1f} s")
    try:
        t = phase("27 surfaces: the CLI in subprocesses on the card")
        cli = cli_phase(env_path, ckpt)
        say(f"  phase 27: {time.perf_counter() - t:.1f} s")
        t = phase("28 surfaces: the ComfyUI nodes")
        nodes = nodes_phase(env_path, ckpt)
        say(f"  phase 28: {time.perf_counter() - t:.1f} s")
    finally:
        import shutil

        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t = phase("29 surfaces: the batching server")
    server = server_phase()
    say(f"  phase 29: {time.perf_counter() - t:.1f} s")
    t = phase("30 training: attention gradient, 2-block gradients, 7B train steps, resume, "
              "ring attention's gradient and 7B ring steps")
    train = {"attention_grad": train_attention_grad_phase(), "dit_grad": train_dit_grad_phase()}
    ring_mesh = open_one_rank_mesh()
    train["ring_grad"] = train_ring_grad_phase(ring_mesh, train["attention_grad"])
    t_ring = time.perf_counter() - t
    train["7b"] = train_7b_phase(ring_mesh=ring_mesh)
    dist.destroy_process_group()
    train["resume"] = train_resume_phase()
    say(f"  phase 30: {time.perf_counter() - t:.1f} s (to the end of (e): {t_ring:.1f} s)")
    t = phase("31 several ranks on the card over gloo: probe, JAX's default mesh, W8A8 at "
              "tensor = 2, ring attention's gradient, GPipe, sharded train steps")
    multi = multi_rank_phase(card)
    say(f"  phase 31: {time.perf_counter() - t:.1f} s")
    t = phase("32 crossattn_emb at full width: the one-token collapse, 512 tokens, W8A8, "
              "tensor = 2")
    crossattn = crossattn_phase(multi)
    say(f"  phase 32: {time.perf_counter() - t:.1f} s")
    t = phase("33 compiled denoise: the replayed step graph against the eager loop, five "
              "renders")
    compiled_renders_phase(env_path, "_eager_denoise")
    say(f"  phase 33: {time.perf_counter() - t:.1f} s")
    t = phase("34 compiled VAE: the replayed encode and decode graphs against the eager VAE, "
              "five renders")
    compiled_vae = compiled_renders_phase(env_path, "_eager_vae")
    say(f"  phase 34: {time.perf_counter() - t:.1f} s")
    t = phase("35 compiled train step: FADITV2_7B steps replayed against eager ones")
    compiled_train = compiled_train_phase()
    say(f"  phase 35: {time.perf_counter() - t:.1f} s")
    t = phase("36 fused norm chains: kernels vs plain chains, timed")
    records.append({"name": "dit_fused", **fused_norms_phase()})
    say(f"  phase 36: {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t_all:.1f} s")
    kernel3 = next(r for r in records if r["name"] == "flash_attention_partial")
    kernel3["launches_train_steps"] = [s_["kernel3_launches"] for s_ in train["7b"]["steps"]]
    kernel3["launches_train_note"] = ("FADITV2_7B train steps (3 at batch 1, 2 at batch 2 "
                                      "with grad_accum=2): 28 per microbatch forward")
    kernel3["launches_train_graph"] = compiled_train["kernel3_launches"]
    for rec in records[:3]:
        key = "flash_attention_headroom" if rec["name"] == "flash_attention_headroom" \
            else "flash_attention"
        rec["launches_compiled_vae"] = {label: r["launches"][key]
                                        for label, r in compiled_vae.items()}
    kernel3["training_shape"] = {k_: train["attention_grad"][k_] for k_ in (
        "shape", "kernel3_fwd_ms", "kernel3_fwd_queued_ms", "fwd_bwd_ms", "fwd_bwd_queued_ms",
        "plain_backward_ms", "library_fwd_bwd_ms", "library_fwd_bwd_queued_ms", "bound_ms",
        "bound_by", "grad_rel_l2", "library")}
    for rec in records[:3]:
        key = "flash_attention_headroom" if rec["name"] == "flash_attention_headroom" \
            else "flash_attention"
        rec["launches_surfaces"] = {
            "cli_inverse": cli["inverse"]["launches"][key],
            "cli_forward": cli["forward"]["launches"][key],
            "node_inverse_bf16": nodes["inverse_bf16"]["launches"][key],
            "node_inverse_w8a8": nodes["inverse_w8a8"]["launches"][key],
            "node_forward": nodes["forward"]["launches"][key],
            "server_dispatch": server["launches"][key]}
    records[3]["launches_surfaces"] = {
        "node_inverse_w8a8": nodes["inverse_w8a8"]["launches"]["quant_matmul_w8a8"]}
    # Phase 31's ranks (host-staged over gloo): launches per rank and the
    # kernels at their per-rank shapes.
    for rec in records[:3]:
        key = "flash_attention_headroom" if rec["name"] == "flash_attention_headroom" \
            else "flash_attention"
        rec["launches_per_rank_default_mesh"] = [r["launches"][key] for r in multi["render"]]
        rec["launches_per_rank_gpipe"] = [r["launches"][key] for r in multi["gpipe"]]
    for rec in records[:2]:
        rec["per_rank_shapes"] = multi["attention_tp"]
    records[3]["launches_per_rank_tensor_parallel"] = {
        label: [r[label]["launches"] for r in multi["w8a8"]] for label in ("w8a8", "w8a8_g128")}
    records[3]["tensor_parallel_shapes"] = multi["qmm_tp"]
    # Phase 32: a DiT forward with a 512-token crossattn_emb.
    for rec in records[:3]:
        rec["launches_crossattn_forward"] = crossattn["b_general"]["launches"][
            "flash_attention_headroom" if rec["name"] == "flash_attention_headroom"
            else "flash_attention"]
    records[3]["launches_crossattn_forward"] = crossattn["c_w8a8"]["launches_crossattn"]
    records[3]["crossattn_shapes"] = crossattn["c_w8a8"]["kernel4"]
    kernel3["launches_per_rank_sharded_train"] = {
        mode: [r[mode]["kernel3_launches"] for r in multi["train"]]
        for mode in ("tensor2", "data2", "gpipe2", "seq2", "seq2_ring")}
    kernel3["launches_per_rank_ring_attention_forward"] = [
        r["kernel3_launches_forward"] for r in multi["ring_attention"]]
    kernel3["launches_ring_train_7b"] = [s_["kernel3_launches"]
                                         for s_ in train["7b"]["ring"]["steps"]]
    kernel3["launches_ring_train_note"] = (
        "ring attention's gradient (RingAttentionFunction): 1 per one-rank ring forward "
        "(phase 30(e)), 28 per FADITV2_7B ring step on one rank (30(f)), 2 per rank per "
        "2-rank ring forward and 8 per rank per 4-block seq = 2 step (phase 31)")
    kernel3["ring_training_shape"] = {k_: train["ring_grad"][k_] for k_ in (
        "shape", "fwd_bwd_ms", "fwd_bwd_queued_ms", "function_fwd_bwd_queued_ms",
        "library_fwd_bwd_queued_ms", "bound_ms", "bound_by", "grad_rel_l2_vs_fp32")}
    say(card)  # again here: the end of a long log is what survives
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
