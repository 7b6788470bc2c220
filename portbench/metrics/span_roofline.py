"""The serial span kernel's share of its roofline: the least time of
every dispatch the reference stepped (each dispatch's state read and
written once, or its ticks' operations, whichever is larger) over the
kernel's traced time, in %."""

from portbench import roofline

KERNEL = "torcells_span_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["traffic"]["mode"] != "serial":
        return None
    spent = sum(s for name, v in tr["by_name"].items() if KERNEL in name
                for s in v)
    if spent <= 0:
        return None
    bound = 0.0
    for e in ctx["episodes"]:
        f, c, h, lr = e["ref"].shape
        for ticks in e["ref"].dispatch_ticks:
            bound += roofline.bound_s(*roofline.span_work(f, h, c, lr,
                                                          ticks))
    return 100.0 * bound / spent
