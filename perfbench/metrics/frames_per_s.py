"""Output frames of whole jobs over the time those jobs took: the window
closes at the end of the last job to finish inside --seconds; a job still
running then is neither counted nor timed."""

from perfbench.harness import stats


def read(rec, ctx):
    rate, span, n = stats.rate_over_whole_jobs(
        [(j["t0"], j["t1"], j["units"]) for j in rec.jobs], rec.window_start, rec.deadline)
    ctx.log(f"perfbench: frames_per_s over {n} whole jobs in {span:.4f} s")
    return rate if n else None
