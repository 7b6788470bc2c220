"""The host's wait on the hop kernel a launch: the tpu policy's
``device_ns`` (its blocking waits in ``consume_flush``, recorded as
``hop_device_ns``) over its launches (``hop_calls``), in us."""


def read(ctx):
    eps = ctx["episodes"]
    n = sum(e.get("hop_calls", 0) for e in eps)
    if not n or any("hop_device_ns" not in e for e in eps):
        return None
    return sum(e["hop_device_ns"] for e in eps) / n / 1e3
