"""The attention calls' least time over the device time of every kernel
that implements them (the headroom kernel included).  The calls come from
the cell's shapes (every DiT block of every step, each VAE encode's and the
decode's mid-block spatial attention), checked against the program's
launch counter; a call's least time is the larger of its FLOPs over the
bf16 peak and q, k, v read once plus o written once over the HBM
bandwidth.  Kernel times are the profiler's, by name."""

from perfbench.harness import flops

KERNELS = ("attention_kernel", "partial_kernel", "bounded_kernel", "headroom_kernel",
           "flash_int8_wgmma_kernel")


def read(rec, ctx):
    if rec.trace is None or not rec.jobs:
        return None
    s = rec.shape
    calls = flops.render_attention_calls(ctx.config["net"], ctx.config["vae"], rows=s["rows"],
                                         latent_thw=s["latent_thw"], steps=s["steps"],
                                         encodes=s["encodes"], cfg_rows=s["cfg_rows"])
    if not s["decoded_whole"]:
        return None  # a chunked decode's calls are not counted here
    expected = sum(c[0] for c in calls)
    launched = [j["launches"].get("flash_attention", 0) for j in rec.jobs]
    if any(n != expected for n in launched):
        ctx.log(f"perfbench: attention_roofline expects {expected} launches a job, "
                f"the program counted {launched}")
        return None
    kernel_s, n = rec.trace.device_seconds(lambda name: any(k in name for k in KERNELS))
    if not n:
        return None
    return 100.0 * len(rec.jobs) * flops.calls_least_seconds(calls) / kernel_s
