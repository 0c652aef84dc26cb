"""diffusionrenderer_tpu_torch: the PyTorch and CUDA port of
diffusionrenderer_tpu for NVIDIA Hopper (H100).

Same configs, module names, layouts and public entry points as the JAX
package; the flash-attention kernels on the inverse-render path are
hand-written CUDA (csrc/), built on first use.  Entry points run on CUDA
unless the caller asks for the CPU (device="cpu").  This package imports
neither JAX nor anything of diffusionrenderer_tpu.
"""

from .config import (
    GBUFFER_INDEX_MAPPING,
    DiTConfig,
    RendererConfig,
    SchedulerConfig,
    VAEConfig,
    get_config_by_model_type,
    get_config_from_tensor_shape,
    get_forward_renderer_config,
    get_inverse_renderer_config,
    get_preset_config,
    validate_config,
)
from .pipeline import DiffusionRendererPipeline

__version__ = "0.1.0"
