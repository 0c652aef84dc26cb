"""Kernels 1 and 2 at the wide heads (D = 256, 512) on the card:
csrc/flash_attention_wgmma.cu built as it is (64 keys a tile at D = 256)
and with DRT_WIDE_BLOCK_K_D256=32 (at D = 512, 64 keys would need 288 KB of
shared memory: 32 is the only tile).  Each build's bounded call (the
no-shift branch on these inputs) and online call are timed beside
F.scaled_dot_product_attention, with its registers, and held against the
plain version (at the flagship shape, against the default build) within
chip_smoke.py's limits.  With --old-csrc DIR (the csrc/ of an earlier
checkout, whose flash_attention.cu exports drt_flash_attention for D = 256
and 512), that mma.sync body is built and timed too, on the same inputs.

Needs a CUDA card and nvcc.  From the root of a checkout:

    python3 scripts/torch_wide_attention_tile.py [--old-csrc DIR]

Prints the card's name and power limit, then one JSON line per shape.
"""

import argparse
import concurrent.futures
import ctypes
import json
import math
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from diffusionrenderer_tpu_torch.ops import cuda_build  # noqa: E402
from diffusionrenderer_tpu_torch.ops import flash_attention as fa  # noqa: E402

# name -> nvcc defines; the default build first (at the flagship shape the
# others are held against it).
VARIANTS = {"default": (), "d256_bk32": ("-DDRT_WIDE_BLOCK_K_D256=32",)}
# (B, Lq, Lk, H, D): the VAE's encode and decode attention at 512x512, the
# flagship's (57 frames at 704x1280: 8 latent frames of 88 x 160 tokens), a
# ragged length, and D = 256.
SHAPES = ((1, 4096, 4096, 1, 512), (5, 4096, 4096, 1, 512), (8, 14080, 14080, 1, 512),
          (1, 1000, 1200, 1, 512), (5, 4096, 4096, 1, 256), (2, 1024, 1024, 8, 256))
MAX_TOL, L2_TOL = 2e-2, 1e-2  # chip_smoke.py's kernel-vs-plain limits


def nvcc(src: str, out_dir: str, defines) -> str:
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "lib.so")
    log = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *defines, "-o", lib, src],
                         capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} {defines}:\n{log.stdout}{log.stderr}")
    return lib


def load_variant(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(nvcc(str(cuda_build.CSRC / "flash_attention_wgmma.cu"),
                           os.path.join(ROOT, "build", "wide_tile", name), VARIANTS[name]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.drt_flash_wgmma_attention.argtypes = [ptr] * 6 + [i32] * 5 + [f32, f32, i32, ptr]
    lib.drt_flash_wgmma_attention.restype = i32
    lib.drt_flash_wgmma_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.drt_flash_wgmma_occupancy.restype = i32
    return lib


def load_old(csrc: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(nvcc(os.path.join(csrc, "flash_attention.cu"),
                           os.path.join(ROOT, "build", "wide_tile", "old_mma_sync"), ()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.drt_flash_attention.argtypes = [ptr] * 6 + [i32] * 5 + [f32, f32, i32, ptr]
    lib.drt_flash_attention.restype = i32
    return lib


def event_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close(got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    return {"max_abs_err": err, "rel_l2": rel,
            "ok": bool(err <= MAX_TOL * want.abs().max().item() and rel <= L2_TOL)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", help="csrc/ of an earlier checkout: time its mma.sync body")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS) + 1) as pool:  # nvcc in parallel
        built = {name: pool.submit(load_variant, name) for name in VARIANTS}
        old = pool.submit(load_old, args.old_csrc) if args.old_csrc else None
        libs = {name: job.result() for name, job in built.items()}
        old = old.result() if old is not None else None
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    tally = torch.zeros(2, dtype=torch.int32, device="cuda")
    ok = True
    for b, lq, lk, h, d in SHAPES:
        g = torch.Generator("cuda").manual_seed(lq + d)
        q, k, v = (torch.randn(b, n, h, d, generator=g, device="cuda").bfloat16()
                   for n in (lq, lk, lk))
        stats = fa.flash_headroom(q, k, v)
        qs, pad = fa._q_scale_value(d, q.dtype), math.log2(fa.reference_lk_pad(lk, d))

        def launch(fn, out, bounded):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), stats.data_ptr(),
                     tally.data_ptr(), b, lq, lk, h, d, qs, pad, int(bounded), stream)
            if err != 0:
                raise RuntimeError(f"launch failed: code {err}")

        big = lq >= 10000
        reps = 3 if big else 10
        want = {}
        if not big:
            want = {True: fa.flash_attention_plain(q, k, v),
                    False: fa.flash_attention_plain(q, k, v, bounded=False)}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec = {"shape": [b, lq, lk, h, d],
               "branch": "noshift" if bool(fa.use_noshift(stats, b * h, lk, d)) else "online",
               "sdpa_ms": event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)}
        for name, lib in libs.items():
            if d == 512 and name != "default":
                continue  # the same kernel at D = 512
            occ = (ctypes.c_int * 6)()
            if lib.drt_flash_wgmma_occupancy(0, d, occ) != 0:
                raise RuntimeError("occupancy query failed")
            r = {"registers": occ[0], "spill_bytes": occ[1], "smem_bytes": occ[2],
                 "blocks_per_sm": occ[3]}
            for bounded in (True, False):
                out = torch.empty_like(q)
                launch(lib.drt_flash_wgmma_attention, out, bounded)
                torch.cuda.synchronize()
                if big and name == "default":
                    want[bounded] = out.clone()
                key = "bounded" if bounded else "online"
                r[f"{key}_ms"] = event_ms(
                    lambda: launch(lib.drt_flash_wgmma_attention, out, bounded), reps)
                if bounded in want:
                    r[f"{key}_check"] = close(out, want[bounded])
                    ok &= r[f"{key}_check"]["ok"]
            rec[name] = r
        if old is not None:
            r = {}
            for bounded in (True, False):
                out = torch.empty_like(q)
                launch(old.drt_flash_attention, out, bounded)
                key = "bounded" if bounded else "online"
                r[f"{key}_ms"] = event_ms(lambda: launch(old.drt_flash_attention, out, bounded),
                                          reps)
                if bounded in want:
                    r[f"{key}_check"] = close(out, want[bounded])
            rec["old_mma_sync"] = r
        print(json.dumps(rec), flush=True)
        del q, k, v, stats, qt, kt, vt, want
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
