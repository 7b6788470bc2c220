"""UDP/TCP echo pair — the smallest end-to-end traffic app.

Args:
    server:  ["udp"|"tcp", "server", port]
    client:  ["udp"|"tcp", "client", server_name, port, n_messages, msg_size]

The client sends n messages and validates each echo; exits 0 on success.
Used by the 2-host smoke workload (BASELINE.md config #1 analog).
"""

from __future__ import annotations

from .registry import register


@register("echo")
def main(api, args):
    proto = args[0] if args else "udp"
    role = args[1] if len(args) > 1 else "server"
    if role == "server":
        port = int(args[2]) if len(args) > 2 else 8000
        if proto == "udp":
            yield from _udp_server(api, port)
        else:
            yield from _tcp_server(api, port)
        return 0
    server = args[2] if len(args) > 2 else "server"
    port = int(args[3]) if len(args) > 3 else 8000
    n = int(args[4]) if len(args) > 4 else 10
    size = int(args[5]) if len(args) > 5 else 1024
    if proto == "udp":
        ok = yield from _udp_client(api, server, port, n, size)
    else:
        ok = yield from _tcp_client(api, server, port, n, size)
    return 0 if ok else 1


def _udp_server(api, port):
    fd = api.socket("udp")
    api.bind(fd, ("0.0.0.0", port))
    api.log(f"udp echo server on :{port}")
    while True:
        data, src = yield from api.recvfrom(fd)
        if not data:
            return
        api.sendto(fd, data, src)


def _udp_client(api, server, port, n, size):
    fd = api.socket("udp")
    ok = True
    for i in range(n):
        msg = bytes([i % 256]) * size
        api.sendto(fd, msg, (server, port))
        data, _ = yield from api.recvfrom(fd)
        if data != msg:
            api.log(f"echo mismatch on message {i}: got {len(data)} bytes")
            ok = False
    api.log(f"udp client done: {n} messages of {size}B echoed ok={ok}")
    api.close(fd)
    return ok


def _tcp_server(api, port):
    lfd = api.socket("tcp")
    api.bind(lfd, ("0.0.0.0", port))
    api.listen(lfd)
    api.log(f"tcp echo server on :{port}")
    while True:
        cfd, peer = yield from api.accept(lfd)
        api.spawn(_tcp_echo_conn, api, cfd)


def _tcp_echo_conn(api, fd):
    while True:
        data = yield from api.recv(fd, 65536)
        if not data:
            api.close(fd)
            return
        yield from api.send(fd, data)


def _tcp_client(api, server, port, n, size):
    fd = api.socket("tcp")
    yield from api.connect(fd, (server, port))
    ok = True
    for i in range(n):
        msg = bytes([i % 256]) * size
        yield from api.send(fd, msg)
        got = b""
        while len(got) < size:
            chunk = yield from api.recv(fd, size - len(got))
            if not chunk:
                ok = False
                break
            got += chunk
        if got != msg:
            ok = False
    api.log(f"tcp client done: {n} messages of {size}B echoed ok={ok}")
    api.close(fd)
    return ok
