"""The port's serving executor (diffusionrenderer_tpu_torch/serving.py) on
the cases of tests/test_serving.py: batching, bucketing, futures, shutdown
and races, on a tiny fp32 pipeline on the CPU.  Every result() and join
has its own timeout, so a hang fails the test instead of stalling the
suite.  At the JAX tests' size (2 rows of 16 x 16, one step) a batched row
equals the same request dispatched alone bit for bit, as there; at 5 rows
of 32 x 32 the CPU's fp32 matmuls round one pixel of one row a uint8 level
apart from its solo run (another blocking for another row count), so that
case holds rows within 1 level."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from diffusionrenderer_tpu_torch.config import DiTConfig, VAEConfig
from diffusionrenderer_tpu_torch.models.dit import init_dit_params
from diffusionrenderer_tpu_torch.models.vae import init_vae_params
from diffusionrenderer_tpu_torch.pipeline import DiffusionRendererPipeline
from diffusionrenderer_tpu_torch.serving import Request, ServingExecutor
from diffusionrenderer_tpu_torch.utils.profiling import metrics

NET = DiTConfig(model_channels=48, num_blocks=1, num_heads=2,
                adaln_lora_dim=8, crossattn_emb_channels=16)
VAE = VAEConfig(encoder_block_out_channels=(8, 12, 16, 16),
                decode_block_out_channels=(12, 16, 16, 16), num_layers=1)
RESULT_S = 120   # one result, however many dispatches are ahead of it
JOIN_S = 300     # a drain of every accepted request


@pytest.fixture(scope="module")
def pipeline():
    return DiffusionRendererPipeline(
        init_dit_params(NET, device="cpu", dtype=torch.float32, seed=0),
        init_vae_params(VAE, device="cpu", dtype=torch.float32, seed=1),
        model_type="inverse", num_steps=1, net_config=NET, vae_config=VAE,
    )


def req(i):
    return {
        "rgb": np.full((1, 1, 16, 16, 3), (i % 5) / 5.0 * 2 - 1, np.float32),
        "context_index": np.asarray([i % 5]),
    }


def big():
    return {"rgb": np.zeros((1, 1, 32, 32, 3), np.float32),
            "context_index": np.zeros((1,), np.int64)}


def test_single_request(pipeline):
    ex = ServingExecutor(pipeline, max_batch=2)
    try:
        out = ex.submit(req(0)).result(timeout=RESULT_S)
        assert out.shape == (1, 1, 16, 16, 3)
        assert out.dtype == np.uint8
    finally:
        ex.shutdown(join_timeout=JOIN_S)


def test_concurrent_requests_all_resolve(pipeline):
    ex = ServingExecutor(pipeline, max_batch=4, max_wait_ms=50)
    try:
        futs = [ex.submit(req(i)) for i in range(6)]
        outs = [f.result(timeout=RESULT_S) for f in futs]
        assert all(o.shape == (1, 1, 16, 16, 3) for o in outs)
        # Different context indices must give different outputs.
        assert np.abs(outs[0].astype(int) - outs[1].astype(int)).max() > 0
    finally:
        ex.shutdown(join_timeout=JOIN_S)


def test_mixed_shapes_bucketed(pipeline):
    ex = ServingExecutor(pipeline, max_batch=4, max_wait_ms=50)
    try:
        small = ex.submit(req(0))
        large = ex.submit(big())
        assert small.result(timeout=RESULT_S).shape == (1, 1, 16, 16, 3)
        assert large.result(timeout=RESULT_S).shape == (1, 1, 32, 32, 3)
    finally:
        ex.shutdown(join_timeout=JOIN_S)


def test_mixed_seeds_match_solo_dispatch(pipeline):
    """Batching never changes a request's output: each batched row equals
    the same request dispatched alone with its own seed, and the two went
    out as one dispatch."""
    solo = {s: pipeline.generate(req(0), seed=s) for s in (7, 1234)}
    assert np.abs(solo[7].astype(int) - solo[1234].astype(int)).max() > 0, \
        "seeds must matter for this test to be meaningful"

    ex = ServingExecutor(pipeline, max_batch=2, max_wait_ms=2000)
    metrics.reset()
    try:
        f1 = ex.submit(req(0), seed=7)
        f2 = ex.submit(req(0), seed=1234)
        np.testing.assert_array_equal(f1.result(timeout=RESULT_S), solo[7])
        np.testing.assert_array_equal(f2.result(timeout=RESULT_S), solo[1234])
    finally:
        ex.shutdown(join_timeout=JOIN_S)
    assert metrics.summary()["serving/dispatch"]["count"] == 1


def test_uint8_batches_stay_uint8_and_mixed_rows_share_one_range(pipeline, monkeypatch):
    """The host-side merge keeps a uint8-only batch uint8 (raw upload), and
    maps uint8 rows of a mixed batch to the float rows' [-1, 1]."""
    seen = []
    generate = pipeline.generate

    def spy(data_batch, **kw):
        seen.append(data_batch["rgb"])
        return generate(data_batch, **kw)

    monkeypatch.setattr(pipeline, "generate", spy)
    u8 = {"rgb": np.full((1, 1, 16, 16, 3), 255, np.uint8),
          "context_index": np.asarray([0])}
    for rows in ([u8, u8], [u8, req(0)]):
        ex = ServingExecutor(pipeline, max_batch=2, max_wait_ms=2000)
        try:
            futs = [ex.submit(r) for r in rows]
            for f in futs:
                f.result(timeout=RESULT_S)
        finally:
            ex.shutdown(join_timeout=JOIN_S)
    assert seen[0].dtype == np.uint8 and seen[0].shape[0] == 2
    assert seen[1].dtype == np.float32
    np.testing.assert_allclose(seen[1][0], 1.0)
    np.testing.assert_allclose(seen[1][1], req(0)["rgb"][0])


def test_failed_dispatch_sets_the_exception_on_its_futures(pipeline):
    ex = ServingExecutor(pipeline, max_batch=2, max_wait_ms=2000)
    try:
        bad = {"rgb": np.zeros((1, 1, 12, 12, 3), np.float32)}  # not a multiple of 16
        futs = [ex.submit(bad), ex.submit(bad)]
        for f in futs:
            with pytest.raises(ValueError):
                f.result(timeout=RESULT_S)
        # The worker survives a failed dispatch.
        assert ex.submit(req(0)).result(timeout=RESULT_S).shape == (1, 1, 16, 16, 3)
    finally:
        ex.shutdown(join_timeout=JOIN_S)


def test_shutdown_idempotent(pipeline):
    ex = ServingExecutor(pipeline)
    ex.shutdown(join_timeout=JOIN_S)
    ex.shutdown(join_timeout=JOIN_S)
    assert not ex._worker.is_alive()


def test_trickle_bounded_by_one_absolute_deadline(pipeline):
    """A steady trickle slower than max_wait does not hold the batch open
    per arrival: batch formation is bounded by one max_wait_ms from the
    first request."""
    ex = ServingExecutor(pipeline, max_batch=8, max_wait_ms=200)
    ex.shutdown(join_timeout=JOIN_S)  # stop the worker; drive _collect_batch directly
    stop = threading.Event()

    def trickle():
        while not stop.is_set():
            ex._queue.put(Request(req(0), 0, False, Future(), ("b",)))
            stop.wait(0.12)  # slower than nothing, faster than max_wait

    t = threading.Thread(target=trickle, daemon=True)
    t0 = time.monotonic()
    t.start()
    try:
        batch = ex._collect_batch()
        elapsed = time.monotonic() - t0
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()
    assert elapsed < 0.6, f"batch held open {elapsed:.2f}s"
    assert 1 <= len(batch) < 8


def test_submit_after_shutdown_raises(pipeline):
    ex = ServingExecutor(pipeline)
    ex.shutdown(join_timeout=JOIN_S)
    with pytest.raises(RuntimeError):
        ex.submit(req(0))


def test_graceful_shutdown_drains_accepted_requests(pipeline):
    """Every future returned by submit before shutdown(drain=True) resolves:
    the worker drains the queue, including different-bucket requests
    deferred mid-batch, before exiting."""
    ex = ServingExecutor(pipeline, max_batch=4, max_wait_ms=20)
    futs = [ex.submit(req(i)) for i in range(5)]
    futs.append(ex.submit(big()))
    ex.shutdown(drain=True, join_timeout=JOIN_S)
    assert not ex._worker.is_alive()
    for i, f in enumerate(futs):
        out = f.result(timeout=1)  # must already be done
        expect = 32 if i == 5 else 16
        assert out.shape == (1, 1, expect, expect, 3)


def test_abort_shutdown_completes_every_future(pipeline):
    """shutdown(drain=False): nothing hangs; each future either resolved
    (already in flight) or fails fast with RuntimeError."""
    ex = ServingExecutor(pipeline, max_batch=2, max_wait_ms=5)
    futs = [ex.submit(req(i)) for i in range(8)]
    ex.shutdown(drain=False, join_timeout=JOIN_S)
    resolved = failed = 0
    for f in futs:
        assert f.done(), "future left pending after shutdown"
        if f.exception() is None:
            resolved += 1
        else:
            assert isinstance(f.exception(), RuntimeError)
            failed += 1
    assert resolved + failed == 8


def test_concurrent_submitters_race_shutdown(pipeline):
    """Threads submitting while shutdown lands: every request is either
    refused at submit time or its future resolves."""
    ex = ServingExecutor(pipeline, max_batch=4, max_wait_ms=5)
    accepted, rejected = [], []
    acc_lock = threading.Lock()
    start = threading.Barrier(5)

    def submitter(tid):
        start.wait(timeout=30)
        for i in range(10):
            try:
                f = ex.submit(req(tid * 10 + i))
            except RuntimeError:
                with acc_lock:
                    rejected.append(tid)
                return
            with acc_lock:
                accepted.append(f)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    start.wait(timeout=30)  # all submitters released together
    time.sleep(0.05)        # let some requests land first
    ex.shutdown(drain=True, join_timeout=JOIN_S)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert accepted, "race produced no accepted requests"
    for f in accepted:
        assert f.result(timeout=1).shape == (1, 1, 16, 16, 3)


def test_mixed_bucket_trickle_fairness(pipeline):
    """Interleaved requests from two shape buckets, arriving as a slow
    trickle, all resolve: a different-bucket arrival closes the current
    batch and is deferred, never dropped or starved."""
    ex = ServingExecutor(pipeline, max_batch=4, max_wait_ms=50)
    try:
        futs = []
        for i in range(6):
            futs.append(ex.submit(req(i) if i % 2 == 0 else big()))
            time.sleep(0.02)
        outs = [f.result(timeout=RESULT_S) for f in futs]
        for i, o in enumerate(outs):
            expect = 16 if i % 2 == 0 else 32
            assert o.shape == (1, 1, expect, expect, 3)
    finally:
        ex.shutdown(join_timeout=JOIN_S)


def test_the_worker_is_the_only_thread_that_runs_the_pipeline(pipeline, monkeypatch):
    threads = set()
    generate = pipeline.generate

    def spy(*a, **kw):
        threads.add(threading.get_ident())
        return generate(*a, **kw)

    monkeypatch.setattr(pipeline, "generate", spy)
    ex = ServingExecutor(pipeline, max_batch=2, max_wait_ms=5)
    try:
        results = []
        callers = [threading.Thread(target=lambda i=i: results.append(
            ex.submit(req(i)).result(timeout=RESULT_S))) for i in range(4)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
    finally:
        ex.shutdown(join_timeout=JOIN_S)
    assert len(results) == 4
    assert threads == {ex._worker.ident}


def test_five_row_dispatch_within_one_level_of_solo_runs():
    net = DiTConfig(model_channels=64, num_blocks=1, num_heads=2, adaln_lora_dim=8,
                    crossattn_emb_channels=16)
    pipe = DiffusionRendererPipeline(
        init_dit_params(net, device="cpu", dtype=torch.float32, seed=0),
        init_vae_params(VAE, device="cpu", dtype=torch.float32, seed=1),
        model_type="inverse", num_steps=2, net_config=net, vae_config=VAE)
    image = np.random.default_rng(29).integers(0, 256, (1, 1, 32, 32, 3), dtype=np.uint8)
    reqs = [{"rgb": image, "context_index": np.asarray([i])} for i in range(5)]
    solo = [pipe.generate(r, seed=i) for i, r in enumerate(reqs)]
    ex = ServingExecutor(pipe, max_batch=5, max_wait_ms=5000)
    metrics.reset()
    try:
        futs = [ex.submit(r, seed=i) for i, r in enumerate(reqs)]
        outs = [f.result(timeout=RESULT_S) for f in futs]
    finally:
        ex.shutdown(join_timeout=JOIN_S)
    assert metrics.summary()["serving/dispatch"]["count"] == 1
    for got, want in zip(outs, solo):
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
