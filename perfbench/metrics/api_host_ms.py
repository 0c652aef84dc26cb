"""Per job, its wall time less the program's generate/<model_type>
seconds (its registry, closed by a synchronize): the API's host work, the
envmap projection and the conversions.  Mean over the window's jobs."""


def read(rec, ctx):
    if not rec.jobs:
        return None
    return 1e3 * sum(j["t1"] - j["t0"] - j["generate_s"] for j in rec.jobs) / len(rec.jobs)
