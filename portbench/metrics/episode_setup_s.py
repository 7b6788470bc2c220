"""Mean host time an experiment spends before its engine loop starts
(configuration, host table, device plane): from the episode's start to
the engine's ``sim_start_wall``."""


def read(ctx):
    eps = ctx["episodes"]
    if not eps:
        return None
    return sum(e["t_loop"] - e["t_start"] for e in eps) / len(eps)
