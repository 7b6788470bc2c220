"""The benchmark of the PyTorch and CUDA port (``shadow_tpu_torch``): Tor
experiments on the device traffic plane, measured in simulated seconds
per wall second and held to a plain reference.  See README.md."""
