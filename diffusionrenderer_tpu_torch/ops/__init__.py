from .attention import attention, attention_xla
from .norms import adaln_modulation, layer_norm_no_affine, modulate, rms_norm
from .patch import patch_embed, patchify, unpatchify
from .rope import apply_rope, rope_3d_angles
from .timestep import sinusoidal_embedding, timestep_embedding
