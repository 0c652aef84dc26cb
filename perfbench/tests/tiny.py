"""Tiny versions of the cells for the CPU tests: the same code path, a
2-block DiT of width 256 (the published 1,024-wide context) and a narrow VAE at 32 x 32 pixels."""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_NET = {"model_channels": 256, "num_blocks": 2, "num_heads": 4, "adaln_lora_dim": 16}
TINY_VAE = {"encoder_block_out_channels": [8, 16, 32, 32],
            "decode_block_out_channels": [16, 32, 32, 32]}
TINY_TRAFFIC = {"height": 32, "width": 32, "steps": 3, "max_jobs": 3, "panorama": [32, 64],
                "max_steps": 6, "trace_steps": 2}


def overrides(cell: str, dtype: str = "float32", limits=None):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = next(w["config"] for w in bench["workloads"] if w["name"] == cell)
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{config}.json").read_text())
    out = {"config": {"net": {**cfg["net"], **TINY_NET}, "vae": {**cfg["vae"], **TINY_VAE},
                      "dtype": dtype},
           "traffic": dict(TINY_TRAFFIC)}
    if limits is not None:
        out["limits"] = limits
    return out


def card_only_metrics():
    """The metrics a CPU run has nothing to read for: the device trace's and
    the card's memory peak."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return ("peak_reserved_gib",) + tuple(m["name"] for m in bench["per_layer"]
                                          if m["source"] == "device_trace")


def run_cell(cell: str, seed: int = 3000000001, dtype: str = "float32", limits=None,
             seconds: float = 30.0, trace: int = 0, allow_missing=None, control=None):
    """(exit code, result) of one tiny run on the CPU; allow_missing
    defaults to card_only_metrics()."""
    import time

    from perfbench import run as bench_run

    args = bench_run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                            "--trace", str(trace)])
    code, result, _ = bench_run.measure(args, device="cpu", require_card=False, control=control,
                                        overrides=overrides(cell, dtype, limits),
                                        allow_missing=(card_only_metrics()
                                                       if allow_missing is None
                                                       else allow_missing),
                                        t_start=time.perf_counter())
    return code, result
