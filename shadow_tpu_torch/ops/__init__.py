"""Device data plane: the per-round packet-hop kernel (CUDA C++ for
``sm_90a`` under ``csrc/``) and its plain PyTorch version.

torch is int64-native, so unlike the JAX package there is no x64 switch to
flip on import; simulation time stays int64 nanoseconds on every device.
"""
