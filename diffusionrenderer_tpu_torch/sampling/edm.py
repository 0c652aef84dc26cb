"""EDM Euler scheduler (counterpart of diffusionrenderer_tpu/sampling/edm.py).

* sigma table: logspace(log10 sigma_max -> log10 sigma_min, N) + terminal
  0, in fp32;
* scale_model_input: c_in = 1/sqrt(sigma^2 + sigma_data^2), fp32, cast back;
* edm_step: denoised = c_skip x + c_out F(x), Euler
  x += (x - denoised)/sigma * (sigma_next - sigma), fp32, cast back.

The trajectory is a Python loop over the table (the JAX package scans).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def edm_sigmas(num_steps: int, sigma_max: float = 80.0, sigma_min: float = 0.02,
               device=None) -> torch.Tensor:
    """(num_steps + 1,) fp32 sigma table with terminal zero."""
    sigmas = np.logspace(np.log10(sigma_max), np.log10(sigma_min), num_steps,
                         dtype=np.float64).astype(np.float32)
    table = np.concatenate([sigmas, np.zeros(1, np.float32)])
    return torch.from_numpy(table).to(device)


def scale_model_input(sample: torch.Tensor, sigma: torch.Tensor,
                      sigma_data: float = 0.5) -> torch.Tensor:
    sig = torch.as_tensor(sigma, dtype=torch.float32, device=sample.device)
    c_in = 1.0 / torch.sqrt(sig ** 2 + sigma_data ** 2)
    return (sample.float() * c_in).to(sample.dtype)


def edm_step(model_output: torch.Tensor, sigma: torch.Tensor, sigma_next: torch.Tensor,
             sample: torch.Tensor, sigma_data: float = 0.5) -> torch.Tensor:
    f = model_output.float()
    x = sample.float()
    s = torch.as_tensor(sigma, dtype=torch.float32, device=sample.device)
    s_next = torch.as_tensor(sigma_next, dtype=torch.float32, device=sample.device)
    c_skip = sigma_data ** 2 / (s ** 2 + sigma_data ** 2)
    c_out = (s * sigma_data) / torch.sqrt(s ** 2 + sigma_data ** 2)
    denoised = c_skip * x + c_out * f
    derivative = (x - denoised) / s
    return (x + derivative * (s_next - s)).to(sample.dtype)


def sample_edm(
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_init: torch.Tensor,
    sigmas: torch.Tensor,
    sigma_data: float = 0.5,
) -> torch.Tensor:
    """Run the Euler trajectory over consecutive (sigma, sigma_next) pairs.

    denoise_fn(x_scaled, sigma) -> F(x); x_init is already scaled by
    sigmas[0].  sigmas stays a device tensor: no host sync per step."""
    x = x_init
    sigmas = sigmas.to(x_init.device)
    for i in range(sigmas.shape[0] - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        f = denoise_fn(scale_model_input(x, sigma, sigma_data), sigma)
        x = edm_step(f, sigma, sigma_next, x, sigma_data)
    return x
