"""The hop kernel's least time a launch.

Copied from ``chip_smoke.py`` (``OPS_PER_LANE``, ``bound``), rewritten to
take a launch's lanes and its distinct (src, dst) pairs as the reference
counted them from the hop record: the packed rows read once (a header row
and a row a lane, 3 words each), each distinct path's latency and
reliability gathered once, each lane's delivery and keep byte written
once, over HBM; or the lanes' 32-bit operations over the ALUs, whichever
is larger.
"""

from __future__ import annotations

from portbench.roofline import bound_s

# 32-bit operations a lane: threefry's 20 rounds (add, 2 shifts, or, xor)
# with 5 key injections and the input adds (~117), the unpack, clamps,
# compares and the max (~15)
OPS_PER_LANE = 132
ROW_BYTES = 3 * 8                # a packed row: rows, uid, send time
PAIR_BYTES = 8 + 4               # an int64 latency and a float32 reliability
OUT_BYTES = 8 + 1                # the delivery time and the keep byte


def launch_work(lanes: int, pairs: int):
    """(bytes, operations) of one launch of ``lanes`` lanes over ``pairs``
    distinct paths."""
    nbytes = (lanes + 1) * ROW_BYTES + pairs * PAIR_BYTES + lanes * OUT_BYTES
    return nbytes, lanes * OPS_PER_LANE


def launch_bound_s(lanes: int, pairs: int) -> float:
    return bound_s(*launch_work(lanes, pairs))
