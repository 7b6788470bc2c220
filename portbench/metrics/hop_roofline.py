"""The hop kernel's share of its roofline: the least time of every
recorded launch of ``packet_hop`` (its lanes and distinct paths as the
reference counted them, ``portbench/roofline_hop.py``) over the kernel's
traced time, in %."""

from portbench import roofline_hop

KERNEL = "packet_hop_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    spent = sum(s for name, v in tr["by_name"].items() if KERNEL in name
                for s in v)
    if spent <= 0:
        return None
    bound = 0.0
    for e in ctx["episodes"]:
        ref = e.get("ref")
        pairs = getattr(ref, "pairs_by_launch", None)
        if pairs is None:
            return None
        for lanes, p in zip(e["hop_lanes"].tolist(), pairs.tolist()):
            bound += roofline_hop.launch_bound_s(lanes, p)
    return 100.0 * bound / spent
