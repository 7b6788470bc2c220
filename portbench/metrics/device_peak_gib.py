"""Peak memory the card's allocator held over the window, GiB."""


def read(ctx):
    return ctx["device_peak_bytes"] / 2 ** 30
