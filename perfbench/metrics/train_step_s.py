"""The window over the train steps it completed, each ending on its loss
fetched to the host; a step still running at --seconds is neither counted
nor timed."""

from perfbench.harness import stats


def read(rec, ctx):
    rate, span, n = stats.rate_over_whole_jobs(
        [(j["t0"], j["t1"], j["units"]) for j in rec.jobs], rec.window_start, rec.deadline)
    ctx.log(f"perfbench: train_step_s over {n} steps in {span:.4f} s")
    return span / n if n else None
