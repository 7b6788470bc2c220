"""Simulated seconds of every finished experiment (lanes summed) over the
window's wall time, from its start to the last experiment's end."""


def read(ctx):
    eps = ctx["episodes"]
    if not eps:
        return None
    return sum(e["sim_s"] for e in eps) / ctx["window_s"]
