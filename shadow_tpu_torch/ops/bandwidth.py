"""Token-bucket parameters of the device traffic plane.

The port's own copy of ``bucket_params`` from the JAX package's
``ops/bandwidth.py`` (the vector twin of host/network_interface.py
TokenBucket.__init__), which ``parallel/device_plane.py`` uses to size every
plane node's bucket.  That module's ``admit_sorted`` (the sequential
token-bucket admission scan) is not ported yet: ROADMAP B11.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import defs, stime

REFILL_NS = 1000000   # == defs.INTERFACE_REFILL_INTERVAL_NS (1 ms)


def bucket_params(rate_kibps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vector twin of host/network_interface.py TokenBucket.__init__."""
    time_factor = stime.SIM_TIME_SEC // REFILL_NS
    refill = (np.asarray(rate_kibps).astype(np.int64) * 1024) // time_factor
    capacity = refill * defs.INTERFACE_CAPACITY_FACTOR + defs.CONFIG_MTU
    return refill, capacity
