"""Kernel 7's key tile on the card: csrc/flash_attention_wgmma.cu built with
DRT_KERNEL7_BLOCK_K = 64 (kernel 6's tile) and 128 (kernel 1's), kernel 7
(flash_attention_bounded_shift's launch) timed at each, beside kernel 6 and
F.scaled_dot_product_attention, with its registers and whether it is bitwise
equal to kernel 6.

Needs a CUDA card and nvcc.  From the root of a checkout:

    python3 scripts/torch_kernel7_tile.py

Prints the card's name and power limit, then one JSON line per shape.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from diffusionrenderer_tpu_torch.ops import cuda_build  # noqa: E402
from diffusionrenderer_tpu_torch.ops import flash_attention as fa  # noqa: E402

TILES = (64, 128)
# (B, L, H, D): the DiT's attention, its head dim 64 variant, the flagship.
SHAPES = ((5, 1024, 32, 128), (5, 1024, 32, 64), (1, 28160, 32, 128))


def build(tile: int) -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "kernel7_tile", f"bk{tile}")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libflash_attention_wgmma.so")
    src = str(cuda_build.CSRC / "flash_attention_wgmma.cu")
    log = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-DDRT_KERNEL7_BLOCK_K={tile}",
                          "-o", lib, src], capture_output=True, text=True)
    if log.returncode != 0:
        raise RuntimeError(f"nvcc failed at tile {tile}:\n{log.stdout}{log.stderr}")
    dll = ctypes.CDLL(lib)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.drt_flash_wgmma_bounded.argtypes = [ptr] * 5 + [i32] * 5 + [f32, i32, i32, ptr]
    dll.drt_flash_wgmma_bounded.restype = i32
    dll.drt_flash_wgmma_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
    dll.drt_flash_wgmma_occupancy.restype = i32
    return dll


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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = {tile: build(tile) for tile in TILES}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for b, l, h, d in SHAPES:
        g = torch.Generator("cuda").manual_seed(55)
        q, k, v = (torch.randn(b, l, h, d, generator=g, device="cuda") for _ in range(3))
        q, k = (x * torch.rsqrt(x.square().mean(-1, keepdim=True)) for x in (q, k))
        q, k, v = (x.bfloat16().contiguous() for x in (q, k, v))
        mb = fa.row_bound(q, k)
        reps = 20 if l <= 1024 else 3

        def launch(lib, pipelined, out):
            err = lib.drt_flash_wgmma_bounded(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                              mb.data_ptr(), b, l, l, h, d,
                                              fa._q_scale_value(d, q.dtype), pipelined, 0, stream)
            if err != 0:
                raise RuntimeError(f"launch failed: code {err}")

        kernel6 = torch.empty_like(q)
        launch(libs[64], 1, kernel6)
        rec = {"shape": [b, l, h, d],
               "kernel6_ms": event_ms(lambda: launch(libs[64], 1, kernel6), reps)}
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec["sdpa_ms"] = event_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)
        for tile, lib in libs.items():
            out = torch.empty_like(q)
            launch(lib, 0, out)
            torch.cuda.synchronize()
            occ = (ctypes.c_int * 6)()
            if lib.drt_flash_wgmma_occupancy(2, d, occ) != 0:
                raise RuntimeError("occupancy query failed")
            rec[f"bk{tile}"] = {"kernel7_ms": event_ms(lambda: launch(lib, 0, out), reps),
                                "bitwise_kernel6": bool(torch.equal(out, kernel6)),
                                "registers": occ[0], "spill_bytes": occ[1],
                                "blocks_per_sm": occ[3]}
        print(json.dumps(rec))
        del q, k, v, mb, kernel6, qt, kt, vt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
