"""The tpu policy's host time a hopped packet: its ``host_flush_ns`` (the
launch's packing and the consume's event pushes, the waits on the card
left out) over the lanes it launched (``lanes_hopped``), in ns."""


def read(ctx):
    eps = ctx["episodes"]
    n = sum(e.get("lanes_hopped", 0) for e in eps)
    if not n or any("host_flush_ns" not in e for e in eps):
        return None
    return sum(e["host_flush_ns"] for e in eps) / n
