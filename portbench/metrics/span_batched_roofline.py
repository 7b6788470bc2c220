"""The batched span kernel's share of its roofline: the bytes and
operations of every lane's dispatches as the reference stepped them,
over the real (unpadded) tables, summed over the window; the larger of
their least times over the kernel's traced time, in %."""

from portbench import roofline

KERNEL = "torcells_span_batched_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["traffic"]["mode"] != "fleet":
        return None
    spent = sum(s for name, v in tr["by_name"].items() if KERNEL in name
                for s in v)
    if spent <= 0:
        return None
    nbytes = ops = 0
    for e in ctx["episodes"]:
        f, c, h, lr = e["ref"].shape
        for ticks in e["ref"].dispatch_ticks:
            b, o = roofline.span_work(f, h, c, lr, ticks)
            nbytes += b
            ops += o
    return 100.0 * roofline.bound_s(nbytes, ops) / spent
