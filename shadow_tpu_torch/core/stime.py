"""Simulation time: a nanosecond-resolution virtual clock.

The reference keeps simulation time as an unsigned 64-bit nanosecond counter
(``SimulationTime`` in src/main/core/support/definitions.h:18) and derives an
"emulated" wall-clock time by offsetting from a fixed boot epoch
(definitions.h:78).  We keep the same contract — integer nanoseconds
everywhere, no floats on the clock path — because event-order parity between
the CPU scheduler policies and the batched TPU kernel requires exact integer
arithmetic on both sides.

All values are plain Python ints (arbitrary precision, always exact); device
code uses int64 and the simulator asserts times stay below 2**63.
"""

from __future__ import annotations

# >>> simgen:begin region=clock spec=293c930bb679 body=0992823276f8
# One simulated nanosecond is the base unit.
SIM_TIME_NS = 1
SIM_TIME_US = 1000
SIM_TIME_MS = 1000000
SIM_TIME_SEC = 1000000000
# <<< simgen:end region=clock
SIM_TIME_MIN = 60 * SIM_TIME_SEC
SIM_TIME_HOUR = 3600 * SIM_TIME_SEC

# Sentinels (reference definitions.h: SIMTIME_INVALID / SIMTIME_MAX).
SIM_TIME_INVALID = -1
SIM_TIME_MAX = (1 << 62)  # far future; still safely inside int64

# Emulated Unix epoch offset: simulated time 0 corresponds to this wall-clock
# instant, so plugins asking for the time of day get a plausible date
# (reference definitions.h:78 uses 946684800s = 2000-01-01T00:00:00Z).
EMULATED_TIME_OFFSET = 946_684_800 * SIM_TIME_SEC


def from_seconds(seconds: float) -> int:
    """Convert (possibly fractional) seconds to integer sim-time ns."""
    return int(round(seconds * SIM_TIME_SEC))


def from_millis(ms: float) -> int:
    return int(round(ms * SIM_TIME_MS))


def to_seconds(t: int) -> float:
    return t / SIM_TIME_SEC

def to_millis(t: int) -> float:
    return t / SIM_TIME_MS


def emulated_from_sim(sim_ns: int) -> int:
    """Emulated (wall-clock-looking) ns since the Unix epoch for a sim time."""
    return sim_ns + EMULATED_TIME_OFFSET


def sim_from_emulated(emu_ns: int) -> int:
    return emu_ns - EMULATED_TIME_OFFSET


def is_valid(t: int) -> bool:
    return 0 <= t < SIM_TIME_MAX
