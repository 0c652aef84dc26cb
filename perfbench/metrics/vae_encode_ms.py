"""pipeline.timings['encode'] (the conditions' VAE encode, closed by a
synchronize), mean per job."""


def read(rec, ctx):
    vals = [j["encode_s"] for j in rec.jobs if j["encode_s"] is not None]
    return 1e3 * sum(vals) / len(vals) if vals else None
