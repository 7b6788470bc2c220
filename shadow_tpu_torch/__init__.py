"""shadow-tpu on PyTorch and CUDA: the ``tpu`` scheduler policy's main path
with its per-round packet-hop step as a hand-written Hopper kernel.

This package is a port of ``shadow_tpu`` (the JAX package, kept beside it as
the reference).  It imports ``torch`` and never ``jax``, and nothing of
``shadow_tpu``: every module it needs is its own copy, at the same relative
path, so a reader finds each counterpart by path.

Planes:
  * control plane  — shadow_tpu_torch.core      (config, hosts, rounds, policies)
  * data plane     — shadow_tpu_torch.ops       (device-resident topology,
                      the packet-hop kernel and its plain torch version)
  * process plane  — shadow_tpu_torch.process   (virtual processes / apps)

Entry points run on ``cuda`` unless the caller asks for the CPU
(``--device cpu`` / ``Options(device="cpu")``); see :mod:`.device`.
"""

__version__ = "0.1.0"

from .core import stime  # noqa: F401
