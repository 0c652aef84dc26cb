"""One run of one benchmark cell on the card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads BENCHMARK.json and the cell's data files, builds the program from the
seed, warms the cell's shapes up (set-up), measures for --seconds, checks
what the timed path produced against the plain reference, and prints one
JSON line: the cell's end-to-end metrics (--trace 0) or per-layer metrics
(--trace 1).  Without a card it exits 3 and prints no result; where a
metric the cell lists reads nothing, it exits 5 and prints no result."""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _set_cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / "build" / "perfbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(args, *, root: Path = ROOT, device=None, require_card: bool = True,
            control=None, overrides=None, allow_missing=(), t_start: float = _T_START):
    """Run the cell; returns (exit code, result dict or None, the loop's
    record or None).  A metric the cell lists that reads nothing fails the
    run.  control runs the cell's control in the program's place (a
    render's 'w8a8', the train step's 'fp8'; calibrate.py and the control
    test); device, require_card, overrides (a dict merged into the cell's
    config, traffic and limits) and allow_missing (metrics that may read
    nothing, such as the device trace's on the CPU) serve the tests."""
    import torch

    from perfbench.harness import card, guard, manifest
    from perfbench.harness.context import Context

    _set_cache_dirs(root)
    bench = manifest.load(root)
    files = manifest.cell_files(root, bench, args.workload)
    for key, extra in (overrides or {}).items():
        files[key] = {**files[key], **extra}
    chips = int(files["cell"]["chips"])
    if require_card:
        why = card.missing(chips)
        if why:
            print(f"perfbench: {why}", file=sys.stderr)
            return 3, None, None
    ctx = Context(root=root, cell=files["cell"], config=files["config"],
                  traffic=files["traffic"], limits=files["limits"], seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), t_start=t_start,
                  device=torch.device(device or "cuda"), control=control)
    loop = manifest.load_module(root / "perfbench" / "loops"
                                  / f"{files['traffic']['loop']}.py")
    rec = loop.run(ctx)

    found = guard.forbidden_modules()
    if found:
        print(f"perfbench: the measured process loaded {', '.join(found)}", file=sys.stderr)
        _print_checks(rec)
        return 4, None, rec

    values, missing = {}, []
    for m in manifest.metrics_for(bench, args.workload, bool(args.trace)):
        reader = manifest.load_module(root / "perfbench" / "metrics" / f"{m['name']}.py")
        v = reader.read(rec, ctx)
        if v is None:
            ctx.log(f"perfbench: metric {m['name']} found nothing to read")
            if m["name"] not in allow_missing:
                missing.append(m["name"])
            continue
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if missing:
        print(f"perfbench: no reading of {', '.join(missing)}, which the cell lists",
              file=sys.stderr)
        _print_checks(rec)
        return 5, None, rec

    device_info = card.describe(chips) if require_card else {
        "platform": str(ctx.device.type), "kind": str(ctx.device), "count": chips,
        "memory_peak_bytes": rec.peak_reserved}
    device_info["memory_peak_bytes"] = int(rec.peak_reserved)
    result = {"correct": bool(rec.checks) and rec.failed == 0
              and all(c["value"] <= c["limit"] for c in rec.checks),
              "attempted": rec.attempted, "failed": rec.failed, "metrics": values,
              "device": device_info}
    if rec.trace is not None:
        busy = rec.trace.busy_ns() / 1e9
        device_info["busy_s"] = busy
        device_info["window_s"] = (rec.trace.end_ns - rec.trace.start_ns) / 1e9
        result["breakdown"] = {"device_ops": rec.trace.top_ops(10),
                               "idle_gaps": rec.trace.idle_gaps(10)}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in rec.checks}
    _print_checks(rec)
    return 0, result, rec


def _print_checks(rec) -> None:
    """Each compared number beside its limit, as the last lines on stderr."""
    for c in rec.checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)


def main(argv=None) -> int:
    args = parse(argv)
    code, result, _ = measure(args)
    if result is not None:
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
