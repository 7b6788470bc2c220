"""Device resolution for the port's entry points.

Stands in for the JAX package's ``utils/cpu_only.py`` (backend pinning) and
its x64 switch (``ops/__init__.py``): torch is int64-native, so there is no
switch, and the device is named by the caller instead of picked by the
framework.  Entry points default to ``cuda``; asking for ``cuda`` on a
machine without a usable card is an error, never a silent run on the CPU.
"""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` -> the current CUDA device (raises RuntimeError when torch
    sees no card); ``"cpu"`` -> the CPU, where every kernel wrapper runs its
    plain torch version."""
    if name == "cpu":
        return torch.device("cpu")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain torch versions "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown device {name!r} (choices: {', '.join(DEVICES)})")
