"""The host's wait on the card a device-plane dispatch: the plane's own
``device_ns`` (its blocking collects) over its dispatches, in ms.  A
fleet lane's dispatch is synchronous and never waits in a collect, so a
fleet cell has nothing to read."""


def read(ctx):
    if ctx["traffic"]["mode"] != "serial":
        return None
    n = sum(e["dispatches"] for e in ctx["episodes"])
    if not n:
        return None
    return sum(e["device_ns"] for e in ctx["episodes"]) / n / 1e6
