"""90th percentile of the wall time of every whole job in the window, from
the call to the returned host arrays."""

from perfbench.harness import stats


def read(rec, ctx):
    times = [j["t1"] - j["t0"] for j in rec.jobs if j["t1"] <= rec.deadline]
    if not times:
        return None
    p90 = stats.percentile(times, 90)
    ctx.log(f"perfbench: job_s_p90 over {len(times)} jobs, "
            f"{stats.count_beyond(times, p90)} beyond it; median {stats.percentile(times, 50):.4f}")
    return p90
