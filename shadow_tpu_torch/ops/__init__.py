"""The port's device kernels (CUDA C++ for ``sm_90a`` under ``csrc/``,
built by ``_build.py``) and their plain PyTorch versions: the per-round
packet hop, the traffic plane's span and flush, the fleet plane's batched
forms, and the model workloads (PHOLD, saturation, the cell model run to
completion, token-bucket admission).

torch is int64-native, so unlike the JAX package there is no x64 switch to
flip on import; simulation time stays int64 nanoseconds on every device.
"""
