from .dit import dit_forward, dit_param_count, init_dit_params
from .vae import init_vae_params, vae_decode, vae_encode
