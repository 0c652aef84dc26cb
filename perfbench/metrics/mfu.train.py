"""3 x the DiT forward's model FLOPs for each step's tokens, over the
traced window of whole steps times the card's bf16 peak (989 TFLOP/s at
700 W; the result line carries the card's power limit)."""

from perfbench.harness import flops, peaks


def read(rec, ctx):
    if rec.trace is None or not rec.jobs:
        return None
    s = rec.shape
    tokens = flops.dit_tokens(ctx.config["net"], s["latent_thw"])
    per_step = 3 * flops.dit_forward_flops(ctx.config["net"], s["rows"], tokens)
    window = (rec.trace.end_ns - rec.trace.start_ns) / 1e9
    return 100.0 * len(rec.jobs) * per_step / (window * peaks.BF16_FLOPS)
