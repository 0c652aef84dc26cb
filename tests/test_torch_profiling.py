"""The port's metrics registry, phase timers, trace and psnr
(utils/profiling.py, utils/metrics.py) against the JAX package's: the same
semantics and summary keys, and the same phase names, counted alike, for
the same generate and inverse_render calls."""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu import api as japi
from diffusionrenderer_tpu.config import DiTConfig as JDiTConfig
from diffusionrenderer_tpu.config import VAEConfig as JVAEConfig
from diffusionrenderer_tpu.models.dit import init_dit_params as j_init_dit
from diffusionrenderer_tpu.models.vae import init_vae_params as j_init_vae
from diffusionrenderer_tpu.pipeline import DiffusionRendererPipeline as JPipeline
from diffusionrenderer_tpu.utils import metrics as jmetrics
from diffusionrenderer_tpu.utils import profiling as jprof
from diffusionrenderer_tpu_torch import api as tapi
from diffusionrenderer_tpu_torch.config import DiTConfig, VAEConfig
from diffusionrenderer_tpu_torch.models.dit import init_dit_params
from diffusionrenderer_tpu_torch.models.vae import init_vae_params
from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline
from diffusionrenderer_tpu_torch.utils import metrics as tmetrics
from diffusionrenderer_tpu_torch.utils import profiling as tprof

NET = dict(model_channels=48, num_blocks=1, num_heads=2, adaln_lora_dim=8,
           crossattn_emb_channels=16)
VAE = dict(encoder_block_out_channels=(8, 12, 16, 16),
           decode_block_out_channels=(12, 16, 16, 16), num_layers=1)


@pytest.fixture(scope="module")
def pipes():
    jnet, jvae = JDiTConfig(**NET), JVAEConfig(**VAE)
    jp = JPipeline(j_init_dit_params(jnet), j_init_vae(jax.random.key(1), jvae, dtype=jnp.float32),
                   model_type="inverse", num_steps=1, compute_dtype="float32",
                   net_config=jnet, vae_config=jvae)
    net, vae = DiTConfig(**NET), VAEConfig(**VAE)
    tp = DiffusionRendererPipeline(init_dit_params(net, device="cpu", dtype=torch.float32, seed=0),
                                   init_vae_params(vae, device="cpu", dtype=torch.float32, seed=1),
                                   model_type="inverse", num_steps=1, net_config=net,
                                   vae_config=vae)
    return jp, tp


def j_init_dit_params(cfg):
    return j_init_dit(jax.random.key(0), cfg, dtype=jnp.float32)


def counts(registry):
    return {k: v["count"] for k, v in registry.summary().items()}


def test_phase_timer_records():
    reg = tprof.MetricsRegistry()
    with tprof.phase_timer("unit", reg):
        time.sleep(0.01)
    s = reg.summary()
    assert s["unit"]["count"] == 1
    assert s["unit"]["mean_s"] >= 0.01


def test_phase_timer_records_when_the_phase_raises():
    reg, jreg = tprof.MetricsRegistry(), jprof.MetricsRegistry()
    for timer, r in ((tprof.phase_timer, reg), (jprof.phase_timer, jreg)):
        with pytest.raises(KeyError):
            with timer("fails", r):
                raise KeyError("x")
    assert counts(reg) == counts(jreg) == {"fails": 1}


def test_timer_context_records_into_the_process_registry():
    tprof.metrics.reset()
    with tprof.Timer("t1") as t:
        time.sleep(0.005)
    assert t.seconds >= 0.005
    assert tprof.metrics.summary()["t1"]["total_s"] == t.seconds


def test_summary_keys_and_values_match_jax():
    reg, jreg = tprof.MetricsRegistry(), jprof.MetricsRegistry()
    for r in (reg, jreg):
        for name, v in (("x", 0.25), ("x", 0.5), ("y", 1.0)):
            r.record(name, v)
    assert reg.summary() == jreg.summary()
    reg.reset()
    assert reg.summary() == {}


def test_registry_counts_every_record_from_many_threads():
    import threading

    reg = tprof.MetricsRegistry()
    threads = [threading.Thread(target=lambda i=i: [reg.record(f"p{i % 3}", 0.0)
                                                    for _ in range(500)]) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sum(counts(reg).values()) == 12 * 500


def test_generate_records_the_same_phases_as_jax(pipes):
    jp, tp = pipes
    batch = {"rgb": np.zeros((1, 1, 16, 16, 3), np.float32),
             "context_index": np.zeros((1,), np.int32)}
    jprof.metrics.reset()
    tprof.metrics.reset()
    jp.generate({k: jnp.asarray(v) for k, v in batch.items()})
    tp.generate(batch)
    assert counts(tprof.metrics) == counts(jprof.metrics)
    assert set(counts(tprof.metrics)) == {"generate/inverse", "generate/encode_conditions",
                                         "generate/denoise", "generate/decode"}
    # One clock: pipeline.timings holds the registry's own seconds.
    s = tprof.metrics.summary()
    for phase, timing in (("encode_conditions", "encode"), ("denoise", "denoise"),
                          ("decode", "decode")):
        assert s[f"generate/{phase}"]["total_s"] == tp.timings[timing]
    assert s["generate/inverse"]["total_s"] >= sum(tp.timings.values())


@pytest.mark.parametrize("batch_passes", [True, False], ids=["batched", "serial"])
def test_inverse_render_records_the_same_phases_as_jax(pipes, batch_passes):
    jp, tp = pipes
    img = np.random.default_rng(0).uniform(size=(1, 16, 16, 3)).astype(np.float32)
    passes = ("depth", "normal", "basecolor")
    jprof.metrics.reset()
    tprof.metrics.reset()
    japi.inverse_render(jp, img, passes=passes, batch_passes=batch_passes)
    tapi.inverse_render(tp, img, passes=passes, batch_passes=batch_passes)
    assert counts(tprof.metrics) == counts(jprof.metrics)
    if not batch_passes:
        assert counts(tprof.metrics)["api/generate_pass"] == 3


def test_resumed_job_records_the_same_phases_as_jax(pipes, tmp_path):
    """A serial job resumed with one pass on disk: one upload, a generate
    for each missing pass, a conversion for every pass."""
    jp, tp = pipes
    img = np.random.default_rng(1).uniform(size=(1, 16, 16, 3)).astype(np.float32)
    got = {}
    for name, api, pipe, reg in (("jax", japi, jp, jprof.metrics),
                                 ("port", tapi, tp, tprof.metrics)):
        d = str(tmp_path / name)
        api.inverse_render(pipe, img, passes=("depth",), resume_dir=d)
        reg.reset()
        api.inverse_render(pipe, img, passes=("depth", "normal"), resume_dir=d)
        got[name] = counts(reg)
    assert got["port"] == got["jax"]
    assert got["port"]["api/generate_pass"] == 1 and got["port"]["api/fetch_convert_output"] == 2


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    d = str(tmp_path / "trace")
    with tprof.trace(d):
        with tprof.annotate("drt_test_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "drt_test_region" for e in events)


def test_device_get_scalar_fetches_the_last_element():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert tprof.device_get_scalar(x) == jprof.device_get_scalar(jnp.asarray(x.numpy())) == 5.0


def test_logger_is_the_port_own():
    assert tprof.logger.name == "diffusionrenderer_tpu_torch"


@pytest.mark.parametrize("peak", [255.0, 1.0])
def test_psnr_matches_jax(peak):
    rng = np.random.default_rng(2)
    a = rng.uniform(0, peak, (4, 8, 3))
    b = a + rng.normal(0, peak / 50, a.shape)
    assert tmetrics.psnr(a, b, peak) == jmetrics.psnr(a, b, peak)
    assert tmetrics.psnr(a, a, peak) == float("inf")
    with pytest.raises(ValueError, match="shape"):
        tmetrics.psnr(a, b[:2], peak)
