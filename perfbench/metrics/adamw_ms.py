"""Device milliseconds a step of the fused AdamW update's kernels (PyTorch's
FusedAdam functor, by name in the profiler's trace)."""


def read(rec, ctx):
    if rec.trace is None or not rec.jobs:
        return None
    seconds, n = rec.trace.device_seconds(lambda name: "Adam" in name)
    return 1e3 * seconds / len(rec.jobs) if n else None
