"""pipeline.timings['decode'] (the VAE decode and the uint8 map, closed
by a synchronize), mean per job."""


def read(rec, ctx):
    vals = [j["decode_s"] for j in rec.jobs if j["decode_s"] is not None]
    return 1e3 * sum(vals) / len(vals) if vals else None
