"""pipeline.timings['denoise'] over the steps, mean over the window's
jobs: one EDM Euler step through the DiT."""


def read(rec, ctx):
    vals = [j["denoise_s"] for j in rec.jobs if j["denoise_s"] is not None]
    if not vals:
        return None
    return 1e3 * sum(vals) / len(vals) / rec.shape["steps"]
