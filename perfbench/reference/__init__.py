"""Plain PyTorch references of the renders the benchmark times: float32
throughout (TF32 off), from the configuration files' sizes and the weights
and inputs the harness draws.  Nothing here imports the program."""
