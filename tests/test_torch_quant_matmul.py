"""The port's W8A8 matmul (ops/quant_matmul.py) against the JAX package's
Pallas kernel in interpret mode, in fp32, on the same numpy inputs.

On the CPU the port runs the kernel's plain version (tests/test_torch_cuda.py
holds the CUDA kernel against this plain version on the card).  The
activation quantize pre-pass is the same fp32-product quantize in both, so
the int8 codes agree exactly and the outputs differ only by the fp32 order
of the scale folds: rtol = atol = 2e-5 as in tests/test_quant_matmul.py.
One case has same-signed codes near +-127 at K = 4,096, where the int32 sum
passes 2^24: there the outputs must be bitwise equal, which an fp32
accumulation of the int8 products does not give."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionrenderer_tpu.models.quant import quantize_tensor as j_quantize_tensor
from diffusionrenderer_tpu.ops.quant_matmul import quant_matmul_w8a8 as j_qmm
from diffusionrenderer_tpu_torch.ops import quant_matmul as tqm


def weights(k, n, group, seed):
    """JAX-quantized W8A8 weight: (codes (K, N), scales) as numpy."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    w[7] *= 25.0  # an outlier row: distinct group scales
    wq = j_quantize_tensor(jnp.asarray(w), act_quant=True, group_size=group)
    return np.asarray(wq["q"]), np.asarray(wq["sa"])


def both(x, q, s):
    want = np.asarray(j_qmm(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), interpret=True))
    got = tqm.quant_matmul_w8a8(torch.from_numpy(x), torch.from_numpy(q.T.copy()),
                                torch.from_numpy(s)).numpy()
    return got, want


@pytest.mark.parametrize("m,k,n,group", [
    (512, 1024, 512, None),   # per channel
    (513, 1024, 512, None),   # ragged M
    (512, 2048, 512, 128),    # groups smaller than JAX's k tile (folds_per_tile)
    (512, 2048, 512, 1024),   # groups larger than JAX's k tile (fold_every)
    (77, 48, 100, None),      # the CUDA kernel's edges: a k32 step across K, partial tiles
    (64, 512, 256, 256),      # one warpgroup's rows; a group spanning two k steps of 128
    (64, 512, 256, 128),
])
def test_plain_matches_jax_kernel(m, k, n, group):
    q, s = weights(k, n, group, seed=m + k + (group or 0))
    x = np.random.default_rng(1).standard_normal((m, k)).astype(np.float32)
    got, want = both(x, q, s)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_lead_dims():
    q, s = weights(1024, 512, 512, seed=4)
    x = np.random.default_rng(4).standard_normal((2, 256, 1024)).astype(np.float32)
    got, want = both(x, q, s)
    assert got.shape == (2, 256, 512)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("group", [None, 512])
def test_int32_sums_past_2_24_are_exact(group):
    """Same-signed codes near 127 at K = 4,096: every dot product is ~6e7,
    where fp32 keeps only multiples of 4 or 8, so summing the int8 products
    in fp32 rounds them differently than the int32 accumulator does."""
    rng = np.random.default_rng(7)
    m, k, n = 64, 4096, 256
    x = rng.uniform(0.8, 1.0, (m, k)).astype(np.float32)
    q = rng.integers(100, 128, (k, n)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, (n,) if group is None else (k // group, n)) * 1e-3
         ).astype(np.float32)
    got, want = both(x, q, s)
    assert np.array_equal(got, want)


def test_kernel_wrapper_refuses_cpu_tensors_and_illegal_shapes():
    xq = torch.zeros(8, 64, dtype=torch.int8)
    dq = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        tqm.quant_matmul_w8a8_kernel(xq, dq, torch.zeros(16, 64, dtype=torch.int8),
                                     torch.ones(16), torch.float32)
    with pytest.raises(ValueError, match="multiple of 16"):
        tqm.check_kernel_shape(8, 16, 40, None)
    with pytest.raises(ValueError, match="multiple of 32"):
        tqm.check_kernel_shape(8, 16, 64, 16)
    assert tqm.LAUNCHES["quant_matmul_w8a8"] == 0  # the CPU path never counts
