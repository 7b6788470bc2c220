"""The device plane's cost model: a stand-in until the port has its own.

The JAX package's ``prof/model.py`` loads a measured per-box cost model
(``COSTMODEL.json``) that the dispatch tuner (``prof/autotune.py``) and the
plane's launch attribution consult.  The checked-in ``COSTMODEL.json`` was
measured for the JAX package's XLA-CPU box and says nothing about this
port's kernels on a GPU, so the port never loads it: calibrating the CUDA
kernels and keeping the port's own model is ROADMAP A7.  Until then
:func:`load_for_engine` reports no model, and the tuner keeps the contract
values (K from ``--superwindow-rounds``, cadence 8, no flush caps), which
are digest-neutral.  An explicit ``--cost-model`` is refused before the run
(``core/controller.py`` ``refuse_unported``).
"""

from __future__ import annotations

from typing import Optional, Tuple


def load_for_engine(options) -> Tuple[Optional[object], str]:
    """``(None, "absent")``, logging that the port has no cost model yet
    (the device plane asks once per run)."""
    from ..core.logger import get_logger
    get_logger().message(
        "prof", "the port has no device cost model yet (ROADMAP A7): the "
        "dispatch tuner keeps its contract values")
    return None, "absent"
