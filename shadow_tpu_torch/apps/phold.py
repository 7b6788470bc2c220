"""PHOLD: the classic PDES scheduler benchmark (reference
src/test/phold/test_phold.c): every host runs one phold process; each
process repeatedly sends a small UDP message to a random peer, which
triggers the peer to send onward.  Stresses the scheduler/event pipeline
with uniform all-to-all traffic.

Args: ["<n_hosts>", "<msgs_in_flight>", "<port>"] — peers are named
``phold1..pholdN`` (quantity-expanded host names).
"""

from __future__ import annotations

from .registry import register


@register("phold")
def main(api, args):
    n_hosts = int(args[0]) if args else 2
    seed_msgs = int(args[1]) if len(args) > 1 else 1
    port = int(args[2]) if len(args) > 2 else 9000
    fd = api.socket("udp")
    api.bind(fd, ("0.0.0.0", port))

    name = api.gethostname()
    try:
        # quantity-expanded names are phold1..pholdN; quantity=1 gives bare
        # "phold"; traffic injectors may have unrelated names
        me_idx = int(name[5:]) - 1 if name.startswith("phold") and name[5:] else -1
    except ValueError:
        me_idx = -1

    def pick_peer():
        # deterministic per-host random peer, never self (classic PHOLD:
        # every hop forwards the message, keeping the population constant)
        if n_hosts <= 1 or me_idx < 0:
            k = api.rand() % n_hosts if n_hosts > 0 else 0
        else:
            k = api.rand() % (n_hosts - 1)
            if k >= me_idx:
                k += 1
        return f"phold{k + 1}"

    me = name
    for _ in range(seed_msgs):
        peer = pick_peer()
        if peer != me:
            api.sendto(fd, b"phold", (peer, port))
    while True:
        data, _src = yield from api.recvfrom(fd)
        if not data:
            return 0
        peer = pick_peer()
        if peer != me:
            api.sendto(fd, b"phold", (peer, port))
