"""The readings a cell's correctness limit is set from, on the card:

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 [--control w8a8|fp8]

For each seed, one short run of the cell through run.measure, as the
benchmark runs it: the program as the configuration states it (bf16)
against the plain float32 reference and, with --control, a run with the
control in the program's place (a render's W8A8 path; the train step's
reference with fp8 matmuls, whose run also reads the program).  Prints per
seed every number the check computes and each run's `correct`, and a
summary: each number's lower reading, the largest over the sound runs, and
upper reading, the smallest over the control's."""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run_once(workload: str, seed: int, seconds: float, control=None):
    """(correct, readings) of one run of the cell; needs the card."""
    import torch

    from perfbench import run as bench_run

    args = bench_run.parse(["--workload", workload, "--seed", str(seed), "--seconds",
                            str(seconds), "--trace", "0"])
    code, result, rec = bench_run.measure(args, control=control, t_start=time.perf_counter())
    if code != 0:
        raise RuntimeError(f"{workload} seed {seed} control {control}: exit {code}")
    readings = rec.notes["readings"]
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    return result["correct"], readings


def readings(workload: str, seeds, control=None, seconds: float = 8.0, log=print):
    """One row per seed: {'seed', 'sound': numbers, control: numbers,
    'correct': {mode: bool}}."""
    rows = []
    for seed in seeds:
        row = {"seed": int(seed), "correct": {}}
        for mode in ([control] if control else []) + [None]:
            if mode is None and "sound" in row:
                break  # the control's run read the program too
            ok, got = run_once(workload, int(seed), seconds, mode)
            row["correct"][mode or "sound"] = ok
            row.update(got)
        log(json.dumps(row))
        rows.append(row)
    return rows


def main(argv=None) -> int:
    from perfbench.harness import card

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", default=None, choices=(None, "w8a8", "fp8"))
    p.add_argument("--seconds", type=float, default=8.0,
                   help="the window: long enough for two whole jobs of the slowest path")
    args = p.parse_args(argv)
    why = card.missing(1)
    if why:
        print(f"calibrate: {why}", file=sys.stderr)
        return 3
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.control,
                    args.seconds, log=lambda line: print(line, flush=True))
    numbers = [k for k, v in rows[0]["sound"].items() if isinstance(v, float)]
    summary = {"workload": args.workload, "seeds": len(rows),
               "lower_reading": {k: max(r["sound"][k] for r in rows) for k in numbers}}
    if args.control:
        summary["upper_reading"] = {k: min(r[args.control][k] for r in rows) for k in numbers}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
