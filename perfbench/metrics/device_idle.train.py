"""The share of the traced window of whole train steps in which no device
operation (kernel, copy, memset) ran: the union of their intervals from
the profiler's timeline."""


def read(rec, ctx):
    if rec.trace is None or not rec.trace.device_ops:
        return None
    window = rec.trace.end_ns - rec.trace.start_ns
    return 100.0 * (1.0 - rec.trace.busy_ns() / window)
