"""The card's idle share of the traced window: 1 - busy / window, where
busy is the union of every kernel, copy and set interval between the
window's two markers, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
