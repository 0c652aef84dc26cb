"""Pipeline orchestration: condition encode -> EDM denoise -> decode -> uint8.

Counterpart of diffusionrenderer_tpu/pipeline.py along the path that
`generate()` takes by default there (staged, with `batch_tile` and
`noise_tile`):

1. each present condition video is VAE-encoded and scaled by sigma_data
   (`encode_condition`), then the conditioning tensor is assembled with
   zeros and mask channels for the missing keys (`assemble_conditions`);
2. the EDM Euler loop runs the DiT, with classifier-free guidance on the
   batch axis (`make_denoise_fn`, `sample`): on the card, one step is
   captured as a CUDA graph and replayed for each (sigma, sigma_next) pair
   (`_StepGraphs`, the counterpart of `_sample_jit`'s scan over one
   compiled step body); on the CPU and under a mesh the loop runs eagerly;
3. the result is VAE-decoded, the normal pass renormalized and blended,
   and the video mapped to uint8 (`decode`); with `decode_chunk_frames`
   set, in overlapping latent-time chunks (`_decode_overlapped`), which
   bounds the decoder's peak memory on long clips.

On the card the encode of one condition and the unchunked decode are
CUDA graphs too (`_VaeGraphs`, the counterparts of `_encode_one_condition_jit`
and `_decode_jit`), captured once per shape and replayed per call; the
chunked decode stays eager.  Every graph runner is a `_GraphRunner`.

Video tensors are channels-last (B, T, H, W, C) at the public functions;
pixel conditions travel channels-first into the VAE.  The random initial
state comes from seeded torch.Generators; `generate(x_init=...)` takes an
explicit one instead (the tests inject the same noise into both packages).

`DiffusionRendererPipeline.shard(mesh)` runs generations over a (data, seq,
tensor) mesh of torch.distributed ranks (parallel/sharding.py): batch rows
split over data when they divide it, DiT tokens over seq, the DiT's heads
and MLP over tensor, and every rank returns the whole result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import RendererConfig, VAEConfig, get_config_by_model_type, validate_config
from .models.dit import dit_forward
from .models.vae import vae_decode, vae_encode
from .ops import dit_fused as _df
from .ops import flash_attention as _fa
from .ops import quant_matmul as _qm
from .parallel.sharding import batch_rows_split, batch_slice, gather_batch
from .sampling.edm import edm_sigmas, euler_step, sample_edm
from .utils.device import synchronize
from .utils.hostops import to_float32
from .utils.layout import ncthw_to_nthwc, nthwc_to_ncthw
from .utils.profiling import annotate, metrics
from .utils.tree import leaves

# Keys searched, in order, to infer the input dimensions.
SHAPE_INFERENCE_KEYS = (
    "rgb", "image", "basecolor", "normal", "depth", "roughness", "metallic",
)


class PixelInput(NamedTuple):
    """A pixel video already on the pipeline's device, channels-first
    (B, C, T, H, W): uint8 in [0, 255], or the compute dtype in [-1, 1].
    shape5 is the logical (B, T, H, W, C).  Built by
    DiffusionRendererPipeline.prepare_pixel_input, so that several
    generations share one upload."""

    arr: torch.Tensor
    shape5: Tuple[int, int, int, int, int]


def compute_dtype_of(cfg: RendererConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _cond_to_ncdhw(z: torch.Tensor, cfg: RendererConfig) -> torch.Tensor:
    """A channels-first condition, uint8 range-mapped [0, 255] -> [-1, 1] as
    x * (2/255) - 1 in the compute dtype, and a one-frame condition
    broadcast over the clip's frames."""
    if z.dtype == torch.uint8:
        dt = compute_dtype_of(cfg)
        # Device fills, not uploads (a CUDA graph capture refuses a host
        # copy); 2/255 rounded to dt first, as the JAX package's multiply.
        z = (z.to(dt) * torch.full((), 2.0 / 255.0, dtype=dt, device=z.device)
             - torch.full((), 1.0, dtype=dt, device=z.device))
    if z.shape[2] == 1 and cfg.num_frames > 1:
        z = z.expand(-1, -1, cfg.num_frames, -1, -1)
    return z


def encode_condition(vae_params, x: torch.Tensor, *, cfg: RendererConfig) -> torch.Tensor:
    """VAE-encode one channels-first condition video, times sigma_data."""
    if x.dtype != torch.uint8:
        x = x.to(compute_dtype_of(cfg))
    z = vae_encode(vae_params, _cond_to_ncdhw(x, cfg), cfg.vae, in_layout="NCDHW")
    return z * cfg.sigma_data


def assemble_conditions(latents: Sequence[torch.Tensor], *, cfg: RendererConfig,
                        present: Tuple[bool, ...], tile: int = 1) -> torch.Tensor:
    """Concatenate the per-key latents (one per present key, in key order)
    with zeros for missing keys and a 0/1 mask channel per key when the
    config appends one; `tile` replicates the result on the batch axis."""
    it = iter(latents)
    ref = latents[0]
    b, t, h, w, c = ref.shape

    def filled(channels, value):
        return torch.full((b, t, h, w, channels), value, dtype=ref.dtype, device=ref.device)

    out = []
    for is_present in present:
        out.append(next(it) if is_present else filled(c, 0.0))
        if cfg.append_condition_mask:
            out.append(filled(1, 1.0 if is_present else 0.0))
    latent = torch.cat(out, dim=-1)
    if tile > 1:
        latent = latent.repeat(tile, 1, 1, 1, 1)
    return latent


def _denoise_inputs(latent_condition: torch.Tensor, ctx: torch.Tensor, guidance: float,
                    use_cfg: bool) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The tensors a denoiser reads besides x and sigma: (latent_condition,
    ctx, g).  Under classifier-free guidance the condition and context rows
    are followed by as many zero rows (the unconditional half) and g is the
    guidance as a 0-dim fp32 device tensor (a fill, not an upload); without
    it g is None."""
    if not use_cfg:
        return latent_condition, ctx, None
    return (torch.cat([latent_condition, torch.zeros_like(latent_condition)], dim=0),
            torch.cat([ctx, torch.zeros_like(ctx)], dim=0),
            torch.full((), guidance, dtype=torch.float32, device=latent_condition.device))


def _denoise_fn(dit_params, lc: torch.Tensor, ctx: torch.Tensor, g: Optional[torch.Tensor], *,
                cfg: RendererConfig, attn_backend: str = "auto", mesh=None,
                mlp_token_chunks: int = 1):
    """denoise_fn(x_scaled, sigma) -> F(x) over _denoise_inputs' tensors:
    with g, the (cond, uncond) pair rides the batch axis of one forward,
    combined as cond + g * (cond - uncond) in fp32."""
    dtype = compute_dtype_of(cfg)
    if g is not None:
        b = lc.shape[0] // 2

        def denoise_fn(x_scaled, sigma):
            out2 = dit_forward(dit_params, torch.cat([x_scaled, x_scaled], dim=0),
                               sigma.to(dtype).expand(2 * b), lc, ctx, cfg.net,
                               attn_backend=attn_backend, mesh=mesh,
                               mlp_token_chunks=mlp_token_chunks)
            out_c, out_u = out2[:b].float(), out2[b:].float()
            return (out_c + g * (out_c - out_u)).to(dtype)

        return denoise_fn

    def denoise_fn(x_scaled, sigma):
        return dit_forward(dit_params, x_scaled, sigma.to(dtype).expand(lc.shape[0]), lc, ctx,
                           cfg.net, attn_backend=attn_backend, mesh=mesh,
                           mlp_token_chunks=mlp_token_chunks)

    return denoise_fn


def make_denoise_fn(dit_params, latent_condition: torch.Tensor, ctx: torch.Tensor,
                    guidance: float, *, cfg: RendererConfig, use_cfg: bool,
                    attn_backend: str = "auto", mesh=None, mlp_token_chunks: int = 1):
    """denoise_fn(x_scaled, sigma) -> F(x).  Under classifier-free guidance
    the (cond, uncond) pair rides the batch axis of one forward, combined
    as cond + g * (cond - uncond) in fp32.  mesh, mlp_token_chunks:
    dit_forward's."""
    return _denoise_fn(dit_params, *_denoise_inputs(latent_condition, ctx, guidance, use_cfg),
                       cfg=cfg, attn_backend=attn_backend, mesh=mesh,
                       mlp_token_chunks=mlp_token_chunks)


def _make_edm_scan_step(denoise_fn, sigma_data: float):
    """step(x, pair) -> x: one EDM Euler step over a (2,) fp32 (sigma,
    sigma_next) device tensor (the JAX package's _make_edm_scan_step, the
    body its _sample_jit scans).  sample_edm loops the same euler_step."""
    return lambda x, pair: euler_step(denoise_fn, x, pair, sigma_data)


def sample(dit_params, latent_condition: torch.Tensor, context_index: torch.Tensor,
           x: torch.Tensor, guidance: float, sigmas: torch.Tensor, *,
           cfg: RendererConfig, use_cfg: bool, attn_backend: str = "auto",
           mesh=None, mlp_token_chunks: int = 1) -> torch.Tensor:
    """Run the Euler trajectory of x over the sigma table `sigmas`, eagerly:
    each step's launches are issued from Python (_StepGraphs.sample replays
    them as one CUDA graph)."""
    dtype = compute_dtype_of(cfg)
    latent_condition = latent_condition.to(dtype)
    ctx = context_index.reshape(latent_condition.shape[0]).long()
    denoise_fn = make_denoise_fn(dit_params, latent_condition, ctx, guidance, cfg=cfg,
                                 use_cfg=use_cfg, attn_backend=attn_backend, mesh=mesh,
                                 mlp_token_chunks=mlp_token_chunks)
    return sample_edm(denoise_fn, x.to(dtype), sigmas, cfg.scheduler.sigma_data)


# The launch counters of the kernels' wrappers (plain Python integers, bumped
# on the host where a wrapper launches): a capture bumps them once, a replay
# never does.
_LAUNCH_COUNTERS = (_fa.LAUNCHES, _fa.VARIANT_LAUNCHES, _qm.LAUNCHES, _df.LAUNCHES)

# Every _GraphRunner's graphs, process-wide (plain Python numbers, bumped on
# the host like the launch counters): graphs captured and replayed; graphs
# dropped by check_weights or clear; and capture_s, the host seconds from a
# key's eager first call (where it has one) to the end of its capture, whose
# own synchronize closes the interval.
GRAPH_STATS: Dict[str, float] = {"captures": 0, "replays": 0, "drops": 0, "capture_s": 0.0}


def _add_launches(counts: Sequence[Dict[str, int]], sign: int = 1) -> None:
    for counter, n in zip(_LAUNCH_COUNTERS, counts):
        for name, k in n.items():
            counter[name] += sign * k


def _capture(body: Callable[[], Any], pool=None):
    """body() captured as a CUDA graph, on the graph's own memory pool or on
    `pool` (another graph's pool(), shared).  Thread-local mode: only the
    capturing thread's calls are checked, so a capture on the serving
    worker does not trip on a client thread's work.  torch.cuda.graph
    releases the default pool's free blocks before it captures."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        body()
    return graph


class _Graph(NamedTuple):
    """One captured graph: `inputs`, the static buffers it reads (refilled
    before a replay; None where the body takes None); `output`, a
    one-element list holding what the body returned (a replay rewrites
    that tensor); `launches`, per counter of _LAUNCH_COUNTERS, the kernel
    launches of one replay; `extra`, what else the caller keeps with it."""

    graph: Any
    inputs: Tuple[Optional[torch.Tensor], ...]
    output: list
    launches: Tuple[Dict[str, int], ...]
    extra: Any = None


class _GraphRunner:
    """CUDA graphs by key over weights they read by raw pointer: the port's
    counterpart of a jitted function's compile cache.

    `check_weights` compares the (address, shape, stride, dtype) of every
    tensor of the given trees with the last call's and drops every graph
    when they differ; `clear` drops them when the owner replaces its
    weights.  `capture` captures fn on zeroed copies of its inputs (the
    capture records launches, it runs nothing); the launch counters count
    executed launches as the eager path does: the capture's bumps are
    taken back out, and `replay` adds one replay's.  With share_pool the
    runner's graphs share one memory pool, which is safe because they are
    replayed one at a time on one stream and each output is read (cloned)
    before the next replay.  A failed capture raises and caches nothing.
    GRAPH_STATS counts what every runner does; each step is a span
    (graph/check_weights, graph/first_call, graph/capture, graph/fill,
    graph/replay)."""

    def __init__(self, share_pool: bool = False):
        self._graphs: Dict[tuple, _Graph] = {}
        self._weights: Optional[tuple] = None
        self._share_pool = share_pool
        self._pool = None

    def clear(self) -> None:
        GRAPH_STATS["drops"] += len(self._graphs)
        self._graphs.clear()
        self._weights = None
        self._pool = None

    def check_weights(self, *trees) -> None:
        with annotate("graph/check_weights"):
            weights = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                            for t in leaves(trees) if isinstance(t, torch.Tensor))
            if weights != self._weights:
                self.clear()
                self._weights = weights

    def get(self, key) -> Optional[_Graph]:
        return self._graphs.get(key)

    def capture(self, key, fn: Callable[..., Any], inputs: Sequence[Optional[torch.Tensor]],
                extra: Any = None, since: Optional[float] = None) -> _Graph:
        """since: the perf_counter() at the key's eager first call, which
        GRAPH_STATS["capture_s"] counts with the capture."""
        t0 = time.perf_counter() if since is None else since
        with annotate("graph/capture"):
            static_in = tuple(None if t is None else torch.zeros_like(t) for t in inputs)
            output: list = [None]

            def body():
                output[0] = fn(*static_in)

            before = [dict(c) for c in _LAUNCH_COUNTERS]
            graph = _capture(body) if self._pool is None else _capture(body, self._pool)
            launches = tuple({name: c[name] - b.get(name, 0) for name in c}
                             for c, b in zip(_LAUNCH_COUNTERS, before))
            _add_launches(launches, -1)
            if self._share_pool and self._pool is None:
                self._pool = graph.pool()
            entry = self._graphs[key] = _Graph(graph, static_in, output, launches, extra)
        GRAPH_STATS["captures"] += 1
        GRAPH_STATS["capture_s"] += time.perf_counter() - t0
        return entry

    @staticmethod
    def fill(entry: _Graph, *values: Optional[torch.Tensor]) -> None:
        """Copy values into the entry's input buffers, in order (None: keep)."""
        with annotate("graph/fill"):
            for buf, value in zip(entry.inputs, values):
                if buf is not None and value is not None:
                    buf.copy_(value)

    @staticmethod
    def replay(entry: _Graph) -> Any:
        with annotate("graph/replay"):
            entry.graph.replay()
        _add_launches(entry.launches)
        GRAPH_STATS["replays"] += 1
        return entry.output[0]

    def run(self, key, fn: Callable[..., Any], *args: torch.Tensor) -> Any:
        """fn(*args) through the key's graph: a key's first call runs fn
        eagerly (which builds the kernels' libraries, warms cuDNN and cuBLAS
        and creates lazy device state outside any capture), then captures
        it; later calls fill, replay and return a clone of the output (the
        next replay of the graph rewrites it)."""
        entry = self.get(key)
        if entry is None:
            t0 = time.perf_counter()
            with annotate("graph/first_call"):
                out = fn(*args)
            self.capture(key, fn, args, since=t0)
            return out
        self.fill(entry, *args)
        return self.replay(entry).clone()


class _StepGraphs(_GraphRunner):
    """The denoise loop as one CUDA graph of an Euler step, captured once
    per key and replayed for each (sigma, sigma_next) pair: the counterpart
    of the JAX package's _sample_jit, which compiles the step once (per its
    static arguments) and scans it.

    The key is _sample_jit's static arguments: the state's shape and dtype,
    the condition's shape and dtype, use_cfg, mlp_token_chunks and the DiT
    config (the attention backend is always 'auto': no mesh reaches here).
    Every call checks the DiT's leaves (check_weights; the leaves also fix
    the quantization mode).

    A key's first call runs step 1 eagerly (it builds the kernels'
    libraries, sets their attributes, warms cuBLAS and creates the lazy
    device state, the branch tally and the Hadamard cache, outside any
    capture), captures the step on zeroed static buffers (x, which it also
    writes, the pair, and _denoise_inputs' tensors), fills them and
    replays the other steps; later calls fill them and replay every step.
    A failed capture or replay raises."""

    def sample(self, dit_params, latent_condition: torch.Tensor, context_index: torch.Tensor,
               x: torch.Tensor, guidance: float, sigmas: torch.Tensor, *, cfg: RendererConfig,
               use_cfg: bool, mlp_token_chunks: int = 1) -> torch.Tensor:
        """`sample` with attn_backend 'auto' and no mesh, its steps replayed."""
        dtype = compute_dtype_of(cfg)
        latent_condition = latent_condition.to(dtype)
        x = x.to(dtype)
        ctx = context_index.reshape(latent_condition.shape[0]).long()
        inputs = _denoise_inputs(latent_condition, ctx, guidance, use_cfg)
        sigmas = sigmas.to(x.device)
        pairs = torch.stack([sigmas[:-1], sigmas[1:]], dim=1)
        if pairs.shape[0] == 0:
            return x

        def make_step(lc, ctx_, g):
            return _make_edm_scan_step(
                _denoise_fn(dit_params, lc, ctx_, g, cfg=cfg, mlp_token_chunks=mlp_token_chunks),
                cfg.scheduler.sigma_data)

        self.check_weights(dit_params)
        key = (tuple(x.shape), x.dtype, tuple(latent_condition.shape), use_cfg,
               mlp_token_chunks, cfg.net, cfg.scheduler.sigma_data)
        entry = self.get(key)
        if entry is None:
            t0 = time.perf_counter()
            with annotate("graph/first_call"):
                x = make_step(*inputs)(x, pairs[0])
            pairs = pairs[1:]
            entry = self.capture(
                key, lambda x_, pair, lc, ctx_, g: x_.copy_(make_step(lc, ctx_, g)(x_, pair)),
                (x, torch.zeros(2, dtype=torch.float32, device=x.device), *inputs), since=t0)
        self.fill(entry, x, None, *inputs)
        for pair in pairs:
            self.fill(entry, None, pair)
            self.replay(entry)
        return entry.inputs[0].clone()


class _VaeGraphs(_GraphRunner):
    """The VAE encode of one condition and the unchunked decode as CUDA
    graphs (the JAX package's _encode_one_condition_jit and _decode_jit,
    each compiled per input shape), captured per key and replayed per call
    (_GraphRunner.run: a key's first call is eager, later calls return a
    clone of the graph's output, so that the forward render's eight
    same-shape conditions each keep their own latent).  The keys hold what
    JAX's static cfg fixes (the VAE config, the compute dtype, the frame
    count a one-frame condition broadcasts to, sigma_data) and the input's
    shape, strides and dtype; every call checks the VAE's leaves.  Encode
    and decode graphs share one memory pool."""

    def __init__(self):
        super().__init__(share_pool=True)

    def encode(self, vae_params, x: torch.Tensor, *, cfg: RendererConfig) -> torch.Tensor:
        """encode_condition(vae_params, x, cfg=cfg), replayed."""
        self.check_weights(vae_params)
        key = ("encode", tuple(x.shape), x.stride(), x.dtype, cfg.vae, cfg.compute_dtype,
               cfg.num_frames, cfg.sigma_data)
        return self.run(key, lambda x_: encode_condition(vae_params, x_, cfg=cfg), x)

    def decode(self, vae_params, sample_: torch.Tensor, normal_mask: torch.Tensor, *,
               cfg: RendererConfig) -> torch.Tensor:
        """decode(vae_params, sample_, normal_mask, cfg=cfg), replayed."""
        self.check_weights(vae_params)
        key = ("decode", tuple(sample_.shape), sample_.stride(), sample_.dtype,
               tuple(normal_mask.shape), normal_mask.dtype, cfg.vae, cfg.compute_dtype,
               cfg.scheduler.sigma_data)
        return self.run(key, lambda s, m: decode(vae_params, s, m, cfg=cfg),
                        sample_, normal_mask)


def resolve_mlp_token_chunks(cfg: RendererConfig, mlp_token_chunks: Optional[int]) -> int:
    """The DiT's MLP token chunks for a generation (the JAX package's rule):
    an int as given; None is 4 when the latent's token count (T/p_t)(H/p_s)
    (W/p_s) is at least 16,384 and divisible by 4 (28,160 at 57x704x1280),
    else 1.  Chunking bounds the (L, 4D) MLP hidden activation."""
    if mlp_token_chunks is not None:
        return int(mlp_token_chunks)
    _, t, h, w = cfg.latent_shape
    net = cfg.net
    tokens = (t // net.patch_temporal) * (h // net.patch_spatial) * (w // net.patch_spatial)
    return 4 if tokens >= 16384 and tokens % 4 == 0 else 1


def noise_init(seed: Union[int, Sequence[int]], sigma0: float, *, shape,
               noise_tile: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The initial state: N(0, 1) * sigma0.  An int seed draws
    shape[0] // noise_tile rows from one generator and tiles them
    noise_tile times; a sequence of seeds draws each row from its own
    generator, so a batched row equals a solo run with that seed."""
    def draw(s, rows):
        gen = torch.Generator(device).manual_seed(int(s))
        return torch.randn((rows, *shape[1:]), generator=gen, device=device,
                           dtype=torch.float32)

    if isinstance(seed, (list, tuple, np.ndarray)):
        noise = torch.cat([draw(s, 1) for s in seed], dim=0)
    else:
        noise = draw(seed, shape[0] // noise_tile).repeat(noise_tile, 1, 1, 1, 1)
    return (noise * sigma0).to(dtype)


def decode(vae_params, sample_: torch.Tensor, normal_mask: torch.Tensor, *,
           cfg: RendererConfig) -> torch.Tensor:
    """Decode, renormalize and blend the rows that normal_mask selects, and
    map [-1, 1] -> uint8 (B, T, H, W, C)."""
    dtype = compute_dtype_of(cfg)
    descaled = (sample_ / cfg.scheduler.sigma_data).to(dtype)
    video = vae_decode(vae_params, descaled, cfg.vae, out_layout="NCDHW").float()
    norm = torch.linalg.vector_norm(video, dim=1, keepdim=True)
    normalized = video / norm.clamp_min(1e-12)
    blend = ((norm - 0.2) / (0.4 - 0.2)).clamp(0.0, 1.0)
    renormed = normalized * blend + video * (1.0 - blend)
    sel = normal_mask.float()[:, None, None, None, None]
    video = renormed * sel + video * (1.0 - sel)
    u8 = ((1.0 + video).clamp(0.0, 2.0) / 2.0 * 255.0).to(torch.uint8)
    return ncthw_to_nthwc(u8)


class DiffusionRendererPipeline:
    """Holds the model parameters and runs generations on their device.

    Public surface of the JAX pipeline: set_model_type, generate, and the
    runtime guidance / num_steps / seed.  `timings` holds the wall seconds
    of the last generation's phases (encode, denoise, decode), each closed
    by a device synchronize; the same seconds go to the metrics registry
    (utils/profiling.metrics) as generate/encode_conditions,
    generate/denoise and generate/decode, and the whole call as
    generate/{model_type}.  After shard(mesh), `mesh` is this rank's
    parallel.sharding.Mesh and `sp_attn` the DiT's attention backend under
    it; `mesh=` in the constructor is shard(mesh).  decode_chunk_frames,
    when set below the clip's latent frame count, decodes it in chunks of
    that many latent frames (_decode_overlapped).  mlp_token_chunks: the
    DiT's MLP token chunks (resolve_mlp_token_chunks: None is the JAX
    package's auto rule, 4 at >= 16,384 tokens); under a mesh each rank
    chunks its own L / seq tokens, and only when the count divides them.

    The denoise runs as a replayed CUDA graph of one Euler step
    (_StepGraphs), and the condition encode and the unchunked decode as
    replayed graphs of their own (_VaeGraphs), whenever the pipeline's
    device is CUDA and it has no mesh; on the CPU, which a caller must ask
    for, and on a sharded pipeline they run eagerly (`sample`,
    `encode_condition`, `decode`), and so does the chunked decode
    everywhere.  The graphs are cached on the pipeline and dropped whenever
    `dit_params` or `vae_params` is assigned (shard, reset_dtype, new
    weights).  `_eager_denoise = True` runs the eager loop on CUDA too, and
    `_eager_vae = True` the eager encode and decode: hooks for comparing
    the two."""

    def __init__(
        self,
        dit_params: Mapping[str, Any],
        vae_params: Mapping[str, Any],
        model_type: Optional[str] = "inverse",
        guidance: float = 0.0,
        num_steps: int = 15,
        seed: int = 42,
        compute_dtype: Optional[str] = None,
        net_config=None,
        vae_config=None,
        mesh=None,
    ):
        self._step_graphs = _StepGraphs()
        self._vae_graphs = _VaeGraphs()
        self._eager_denoise = False
        self._eager_vae = False
        self.dit_params = dit_params
        self.vae_params = vae_params
        self.model_type = model_type.lower() if model_type else None
        self.guidance = guidance
        self.num_steps = num_steps
        self.seed = seed
        conv_w = vae_params["encoder"]["conv_in"]["conv_s"]["w"]
        self.device = conv_w.device
        if compute_dtype is None:
            # Follow the weights: fp32 parameters run fp32, bf16 run bf16.
            compute_dtype = "float32" if conv_w.dtype == torch.float32 else "bfloat16"
        self.compute_dtype = compute_dtype
        self.net_config = net_config
        self.vae_config = vae_config
        self.timings: Dict[str, float] = {}
        self.mesh = None
        self.sp_attn = "auto"
        # Latent frames per decode chunk (None: one decode).  Each chunk
        # restarts the decoder's causal state one latent early, the
        # reference's own long-video behaviour.
        self.decode_chunk_frames: Optional[int] = None
        # MLP token chunks inside each DiT block (None: the auto rule).
        self.mlp_token_chunks: Optional[int] = None
        if mesh is not None:
            self.shard(mesh)

    @property
    def dit_params(self) -> Mapping[str, Any]:
        return self._dit_params

    @dit_params.setter
    def dit_params(self, params: Mapping[str, Any]) -> None:
        # The graphs read the old weights through raw pointers.
        self._step_graphs.clear()
        self._vae_graphs.clear()
        self._dit_params = params

    @property
    def vae_params(self) -> Mapping[str, Any]:
        return self._vae_params

    @vae_params.setter
    def vae_params(self, params: Mapping[str, Any]) -> None:
        self._step_graphs.clear()
        self._vae_graphs.clear()
        self._vae_params = params

    def _denoise_on_graph(self) -> bool:
        """Whether generate's denoise replays a step graph: on CUDA without a
        mesh (and without the _eager_denoise hook)."""
        return self.device.type == "cuda" and self.mesh is None and not self._eager_denoise

    def _vae_on_graph(self) -> bool:
        """Whether generate's condition encode and unchunked decode replay
        VAE graphs: on CUDA without a mesh (and without the _eager_vae
        hook)."""
        return self.device.type == "cuda" and self.mesh is None and not self._eager_vae

    def shard(self, mesh, sp_attn: Optional[str] = None) -> "DiffusionRendererPipeline":
        """Run generations over a (data, seq, tensor) mesh
        (parallel.sharding.make_mesh or make_hybrid_mesh; every rank builds
        the same pipeline and calls generate alike).  With tensor > 1 the
        DiT's block matmuls are cut to this rank's Megatron shard
        (parallel.dit_param_shardings) and the whole weights freed; the VAE
        stays whole on every rank.  sp_attn overrides the DiT's attention
        under the mesh: 'auto', 'flash_sp', 'ring', or an ops.attention
        backend run on the all-gathered KV."""
        from .parallel.sharding import dit_param_shardings, shard_params, vae_param_shardings

        if self.mesh is not None and self.mesh.tensor > 1:
            raise ValueError("the pipeline's DiT is already cut to a tensor-parallel shard")
        if sp_attn is not None:
            self.sp_attn = sp_attn
        self.dit_params = shard_params(self.dit_params,
                                       dit_param_shardings(self.dit_params, mesh))
        self.vae_params = shard_params(self.vae_params,
                                       vae_param_shardings(self.vae_params, mesh))
        if mesh.tensor > 1 and self.device.type == "cuda":
            torch.cuda.empty_cache()  # the whole weights' blocks, for the other ranks
        self.mesh = mesh
        return self

    def set_model_type(self, model_type: str) -> None:
        """Inverse and forward use different checkpoints; switching only
        changes the config (the weights are checked at generate time)."""
        self.model_type = model_type.lower()

    def prepare_pixel_input(self, video) -> PixelInput:
        """Upload a host (B, T, H, W, C) video (uint8, or floats in [-1, 1])
        once, channels-first on the pipeline's device, for any number of
        generate() calls."""
        shape5 = tuple(np.shape(video))
        return PixelInput(self._upload(video), shape5)

    def _upload(self, x) -> torch.Tensor:
        if isinstance(x, PixelInput):
            return x.arr
        with annotate("pipeline/upload"):
            if isinstance(x, torch.Tensor):
                t = x
            else:
                arr = np.asarray(x)
                t = torch.from_numpy(arr if arr.dtype == np.uint8 else to_float32(arr))
            if t.dtype != torch.uint8:
                t = t.to(torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32)
            return nthwc_to_ncthw(t.to(self.device))

    def _config_for(self, shape_5d: Tuple[int, ...]) -> RendererConfig:
        _, t, h, w, _ = shape_5d
        cfg = get_config_by_model_type(self.model_type, height=h, width=w, num_frames=t,
                                       compute_dtype=self.compute_dtype)
        if self.net_config is not None:
            cfg = dataclasses.replace(cfg, net=self.net_config)
        if self.vae_config is not None:
            cfg = dataclasses.replace(cfg, vae=self.vae_config)
        validate_config(cfg)
        patch_dim = self.dit_params["x_embedder"]["weight"].shape[1]
        if patch_dim != cfg.net.patch_dim:
            raise ValueError(
                f"Loaded DiT weights have patch_dim {patch_dim} but model_type "
                f"{self.model_type!r} needs {cfg.net.patch_dim}. Load the "
                f"matching checkpoint (inverse=132, forward=612).")
        return cfg

    def _vae_cfg(self, cfg: Optional[RendererConfig]) -> VAEConfig:
        if cfg is not None:
            return cfg.vae
        return self.vae_config if self.vae_config is not None else VAEConfig()

    def encode(self, x: torch.Tensor, cfg: Optional[RendererConfig] = None) -> torch.Tensor:
        """VAE encode with the EDM scaling vae.encode(x) * sigma_data;
        x: (B, T, H, W, 3) in [-1, 1]."""
        sd = cfg.sigma_data if cfg is not None else 0.5
        return vae_encode(self.vae_params, x, self._vae_cfg(cfg)) * sd

    def decode(self, z: torch.Tensor, cfg: Optional[RendererConfig] = None) -> torch.Tensor:
        """VAE decode with the EDM scaling vae.decode(z / sigma_data)."""
        sd = cfg.sigma_data if cfg is not None else 0.5
        return vae_decode(self.vae_params, z / sd, self._vae_cfg(cfg))

    def reset_dtype(self, dtype: torch.dtype) -> None:
        """Cast the weights to `dtype`, with the JAX package's rule on its
        stacked tree: int8 leaves, the quantization scales ('s', 'sa') and
        1-D leaves stay as they are.  A per-block leaf of the port counts
        the JAX package's stacked block axis, so a block's (D,) norm weight
        is cast as JAX's (nb, D) one is."""
        def cast(tree, path=(), ndim_extra=0):
            if isinstance(tree, dict):
                return {k: cast(v, path + (k,), ndim_extra) for k, v in tree.items()}
            if isinstance(tree, list):
                extra = 1 if path and path[-1] == "blocks" else 0
                return [cast(v, path, ndim_extra + extra) for v in tree]
            if any(k in ("s", "sa") for k in path) or tree.dtype == torch.int8:
                return tree
            return tree.to(dtype) if tree.dim() + ndim_extra > 1 else tree

        self.dit_params = cast(self.dit_params)
        self.vae_params = cast(self.vae_params)

    def _decode_overlapped(self, sample: torch.Tensor, normal_mask: torch.Tensor,
                           cfg: RendererConfig, chunk: int, overlap: int = 1) -> np.ndarray:
        """Decode latent-time chunks of `chunk` latents, each after the first
        starting `overlap` latents early (causal context) and keeping only
        its frames past the overlap; uint8 (B, (T_lat-1)*8+1, H, W, C) on
        the host.  The first chunk's frames are exactly the unchunked
        decode's.  Batch rows decode one at a time (the decoder's peak grows
        with them too).  Every chunk is queued before the first is fetched,
        so each fetch overlaps the next chunk's decode."""
        if sample.shape[0] > 1:
            return np.concatenate([
                self._decode_overlapped(sample[i:i + 1], normal_mask[i:i + 1], cfg, chunk,
                                        overlap)
                for i in range(sample.shape[0])], axis=0)
        t_lat = sample.shape[1]
        step = chunk - overlap
        if step < 1:
            raise ValueError(f"decode chunk {chunk} must exceed the overlap {overlap}")
        queued = []
        start = 0
        while start < t_lat:
            length = min(chunk, t_lat - start)
            if start > 0 and length <= overlap:
                break  # fully covered by the previous chunk
            queued.append((start, length,
                           decode(self.vae_params, sample[:, start:start + length],
                                  normal_mask, cfg=cfg)))
            start += step
        pieces = []
        for start, length, video in queued:
            keep = (video.shape[1] if start == 0
                    else cfg.vae.temporal_compression_ratio * (length - overlap))
            pieces.append(video[:, -keep:].cpu().numpy())
        return np.concatenate(pieces, axis=1)

    @contextlib.contextmanager
    def _phase(self, metric: str, timing: Optional[str] = None):
        """Time a phase up to a device synchronize: the seconds go to the
        metrics registry under `metric` and, when `timing` is given, to
        timings[timing]; one clock for both, inside a span of `metric`."""
        with annotate(metric):
            t0 = time.perf_counter()
            try:
                yield
                synchronize(self.device)
            finally:
                seconds = time.perf_counter() - t0
                if timing is not None:
                    self.timings[timing] = seconds
                metrics.record(metric, seconds)

    @torch.inference_mode()
    def generate(
        self,
        data_batch: Mapping[str, Any],
        normalize_normal=False,
        seed: Union[int, Sequence[int], None] = None,
        noise_tile: int = 1,
        batch_tile: int = 1,
        x_init: Optional[torch.Tensor] = None,
        defer_fetch: bool = False,
    ) -> Union[np.ndarray, torch.Tensor]:
        """Run one generation; returns uint8 (B, T, H, W, C) on the host, or,
        with defer_fetch=True, the same uint8 tensor still on the pipeline's
        device (gathered whole on a sharded pipeline), for a caller that
        copies it later (api.inverse_render's serial loop).  defer_fetch
        always takes the unchunked decode, whatever decode_chunk_frames
        says, as in JAX.

        data_batch maps condition keys to (B, T, H, W, C) videos (host
        arrays, tensors or PixelInputs) and may hold a (B,) context_index.
        batch_tile=n encodes the condition video once and replicates its
        latent n-fold (the batched multi-pass inverse job); noise_tile=n
        replicates one noise draw over n row groups; a sequence of seeds
        gives each row its own.  x_init, when given, is the initial state
        (B, T', H', W', C_lat), already scaled by sigma_max.

        On a sharded pipeline the B rows split over the mesh's data axis
        when they divide it (before the encode when batch_tile is 1, after
        the tiling otherwise) and are replicated when they do not; the noise
        is drawn for all rows on every rank and then sliced, so the result
        equals an unsharded run's; every rank returns all B rows."""
        if self.model_type is None:
            raise RuntimeError("model_type not set; call set_model_type first")
        shape_key = next((k for k in SHAPE_INFERENCE_KEYS if k in data_batch), None)
        if shape_key is None:
            raise ValueError(f"No tensor for shape inference; looked for {SHAPE_INFERENCE_KEYS}")
        sval = data_batch[shape_key]
        shape5 = tuple(sval.shape5) if isinstance(sval, PixelInput) else tuple(np.shape(sval))
        cfg = self._config_for(shape5)
        dtype = compute_dtype_of(cfg)
        present = tuple((k in data_batch) or (k == "image" and "rgb" in data_batch)
                        for k in cfg.condition_keys)

        b = shape5[0] * batch_tile
        ctx = data_batch.get("context_index")
        ctx = (torch.zeros(b, dtype=torch.long, device=self.device) if ctx is None
               else torch.as_tensor(np.asarray(ctx)).reshape(b).long().to(self.device))
        seed = self.seed if seed is None else seed
        per_row = isinstance(seed, (list, tuple, np.ndarray))
        if per_row:
            seed = [int(s) for s in np.asarray(seed).reshape(-1)]
            if len(seed) != b:
                raise ValueError(f"got {len(seed)} per-row seeds for batch of {b}")
            if noise_tile != 1:
                raise ValueError("per-row seeds and noise_tile are exclusive")
        if isinstance(normalize_normal, bool):
            normal_mask = torch.full((b,), float(normalize_normal), device=self.device)
        else:
            normal_mask = torch.as_tensor(
                np.asarray(normalize_normal, np.float32)).reshape(b).to(self.device)

        mesh = self.mesh
        split = mesh is not None and batch_rows_split(b, mesh)
        pre_split = split and batch_tile == 1  # slice the pixel rows before the encode
        rows = (lambda x: batch_slice(x, mesh)) if split else (lambda x: x)  # noqa: E731

        vae_graph = self._vae_on_graph()
        encode = self._vae_graphs.encode if vae_graph else encode_condition
        with self._phase(f"generate/{self.model_type}"):
            with self._phase("generate/encode_conditions", "encode"):
                latents = []
                for i, key in enumerate(cfg.condition_keys):
                    if present[i]:
                        src = key if key in data_batch else "rgb"
                        pixels = self._upload(data_batch[src])
                        latents.append(encode(
                            self.vae_params, rows(pixels) if pre_split else pixels, cfg=cfg))
                latent_condition = assemble_conditions(latents, cfg=cfg, present=present,
                                                       tile=batch_tile)
                if split and not pre_split:
                    latent_condition = rows(latent_condition)
                del latents
            with self._phase("generate/denoise", "denoise"):
                with annotate("generate/noise"):
                    sigmas = edm_sigmas(self.num_steps, cfg.scheduler.sigma_max,
                                        cfg.scheduler.sigma_min)
                    state_shape = (b, *latent_condition.shape[1:4], cfg.vae.latent_channels)
                    if x_init is not None:
                        if tuple(x_init.shape) != state_shape:
                            raise ValueError(f"x_init has shape {tuple(x_init.shape)}, "
                                             f"expected {state_shape}")
                        x = x_init.to(device=self.device, dtype=dtype)
                    else:
                        x = noise_init(seed, float(sigmas[0]), shape=state_shape,
                                       noise_tile=noise_tile, dtype=dtype, device=self.device)
                chunks = resolve_mlp_token_chunks(cfg, self.mlp_token_chunks)
                if self._denoise_on_graph():
                    x = self._step_graphs.sample(
                        self.dit_params, latent_condition, ctx, x, self.guidance, sigmas,
                        cfg=cfg, use_cfg=self.guidance > 0, mlp_token_chunks=chunks)
                else:
                    x = sample(self.dit_params, latent_condition, rows(ctx), rows(x),
                               self.guidance, sigmas, cfg=cfg, use_cfg=self.guidance > 0,
                               attn_backend="auto" if mesh is None else self.sp_attn,
                               mesh=mesh, mlp_token_chunks=chunks)
                del latent_condition
            with self._phase("generate/decode", "decode"):
                ck = self.decode_chunk_frames
                if ck and x.shape[1] > ck and not defer_fetch:
                    video_u8 = self._decode_overlapped(x, rows(normal_mask), cfg, ck)
                    if split:
                        video_u8 = gather_batch(torch.from_numpy(video_u8).to(self.device),
                                                mesh, b).cpu().numpy()
                else:
                    video = (self._vae_graphs.decode if vae_graph else decode)(
                        self.vae_params, x, rows(normal_mask), cfg=cfg)
                    if split:
                        video = gather_batch(video, mesh, b)
                    video_u8 = video if defer_fetch else video.cpu().numpy()
        return video_u8
