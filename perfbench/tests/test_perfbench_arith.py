"""The yardstick's arithmetic against hand-worked numbers."""

import json

import pytest
from tiny import ROOT

from perfbench.harness import flops, stats


def _net(config):
    return json.loads((ROOT / "perfbench" / "configs" / f"{config}.json").read_text())["net"]


def test_dit_flops_per_token_at_1024_and_28160_tokens():
    net = _net("dr_inverse_7b")
    # 28 blocks x (24 d^2 + 4 L d) + the patch embed and final layer, per token.
    assert flops.dit_forward_flops(net, 1, 1024) / 1024 == pytest.approx(11.74e9, rel=2e-3)
    assert flops.dit_forward_flops(net, 1, 28160) / 28160 == pytest.approx(24.19e9, rel=2e-3)


def test_inverse_step_is_60_tflop():
    net = _net("dr_inverse_7b")
    tokens = flops.dit_tokens(net, (1, 64, 64))
    assert tokens == 1024
    assert flops.dit_forward_flops(net, 5, tokens) == pytest.approx(5120 * 11.74e9, rel=2e-3)
    assert flops.dit_forward_flops(net, 5, tokens) == pytest.approx(60.1e12, rel=3e-3)


def test_attention_bound_at_the_long_video_shape():
    assert flops.attention_flops(1, 32, 28160, 28160, 128) == pytest.approx(13.0e12, rel=1e-3)
    assert flops.attention_least_seconds(1, 32, 28160, 28160, 128) == pytest.approx(
        13.14e-3, rel=1e-3)
    # A small call is bound by its bytes: q, k, v read and o written once.
    b = flops.attention_bytes(1, 1, 16, 16, 64)
    assert b == 2 * 64 * (2 * 16 + 2 * 16)
    assert flops.attention_least_seconds(1, 1, 16, 16, 64) == pytest.approx(b / 3.35e12)


def test_render_calls_match_the_launch_counts():
    inv = json.loads((ROOT / "perfbench" / "configs" / "dr_inverse_7b.json").read_text())
    calls = flops.render_attention_calls(inv["net"], inv["vae"], rows=5, latent_thw=(1, 64, 64),
                                         steps=15, encodes=1)
    assert sum(c[0] for c in calls) == 422  # 15 x 28 DiT blocks, one encode, one decode
    calls = flops.render_attention_calls(inv["net"], inv["vae"], rows=1, latent_thw=(1, 64, 64),
                                         steps=15, encodes=8)
    assert sum(c[0] for c in calls) == 429


def test_rate_over_whole_jobs_drops_the_job_past_the_deadline():
    jobs = [(0.0, 2.0, 5), (2.0, 4.0, 5), (4.0, 6.5, 5)]
    rate, span, n = stats.rate_over_whole_jobs(jobs, 0.0, 6.0)
    assert (rate, span, n) == (10 / 4.0, 4.0, 2)
    assert stats.rate_over_whole_jobs(jobs, 0.0, 1.0) == (0.0, 0.0, 0)


def test_percentile_and_its_count():
    times = [float(i) for i in range(1, 21)]  # 1 .. 20
    p90 = stats.percentile(times, 90)
    assert p90 == pytest.approx(18.1)
    assert stats.count_beyond(times, p90) == 2
    assert stats.percentile([3.0], 90) == 3.0


def test_quartile_spread():
    assert stats.quartile_spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def test_union_gaps_and_idle_share():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert stats.union_length(iv) == 4.0
    assert stats.gaps(iv, 0.0, 8.0) == [(3.0, 5.0), (6.0, 8.0)]
    assert stats.idle_share(iv, 0.0, 8.0) == pytest.approx(0.5)
    # Intervals are cut to the window.
    assert stats.idle_share(iv, 1.0, 6.0) == pytest.approx(0.4)
