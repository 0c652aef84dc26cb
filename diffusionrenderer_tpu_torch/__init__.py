"""diffusionrenderer_tpu_torch: the PyTorch and CUDA port of
diffusionrenderer_tpu for NVIDIA Hopper (H100).

Same configs, module names, layouts and public entry points as the JAX
package (load_pipeline, inverse_render, forward_render, load_hdr, and the
trainer: make_train_step, train_loop); every
kernel that the JAX package wrote in Pallas has a hand-written CUDA
counterpart (csrc/), built on first use.  Entry points run on CUDA unless
the caller asks for the CPU (device="cpu").  This package imports
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
from .api import forward_render, inverse_render, load_hdr, load_pipeline
from .training import (TrainState, edm_loss, init_train_state, make_optimizer,
                       make_train_step, train_loop)

__version__ = "0.1.0"


def __getattr__(name):
    # ComfyUI discovers plugins by reading NODE_CLASS_MAPPINGS off the
    # package; loaded on first access so library users never import the
    # node layer.
    if name in ("NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"):
        from . import comfy_nodes

        return getattr(comfy_nodes, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
