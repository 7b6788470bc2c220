"""Peak resident memory of the run's process (getrusage), GiB."""


def read(ctx):
    return ctx["host_peak_bytes"] / 2 ** 30
