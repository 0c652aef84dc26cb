from .edm import edm_sigmas, edm_step, sample_edm, scale_model_input
