"""One-way traffic source/sink pair (loss-tolerant, unlike echo).

Used by the CPU<->TPU parity tests and benchmarks: the source sends N
datagrams at a fixed interval without waiting for replies; the sink counts
arrivals and records their virtual timestamps, so two runs can be compared
for exact delivery parity even on lossy links.

Args:
    source: ["udp", dst_name, port, n, size, interval_sec]
    sink:   ["udp", port]
"""

from __future__ import annotations

from .registry import register


class SinkState:
    __slots__ = ("received", "bytes", "arrival_times")

    def __init__(self):
        self.received = 0
        self.bytes = 0
        self.arrival_times = []


@register("sink")
def sink_main(api, args):
    port = int(args[1]) if len(args) > 1 else 8000
    state = SinkState()
    api.process.app_state = state
    fd = api.socket("udp")
    api.bind(fd, ("0.0.0.0", port))
    api.log(f"sink listening on :{port}")
    while True:
        data, _src = yield from api.recvfrom(fd)
        if not data:
            return 0
        state.received += 1
        state.bytes += len(data)
        state.arrival_times.append(api.now_ns())


@register("source")
def source_main(api, args):
    dst = args[1] if len(args) > 1 else "server"
    port = int(args[2]) if len(args) > 2 else 8000
    n = int(args[3]) if len(args) > 3 else 10
    size = int(args[4]) if len(args) > 4 else 512
    interval = float(args[5]) if len(args) > 5 else 0.01
    fd = api.socket("udp")
    for i in range(n):
        api.sendto(fd, bytes([i % 256]) * size, (dst, port))
        if interval > 0:
            yield from api.sleep(interval)
    api.log(f"source done: {n} x {size}B to {dst}:{port}")
    api.close(fd)
    return 0
