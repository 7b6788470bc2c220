"""File-transfer app: N clients download a payload from a server over TCP.

Mirrors the reference's built-in ``--test`` workload (examples.c: 1000
clients x 10 downloads of /bin/ls served by a filetransfer plugin).

Args:
    server: ["server", port, file_size_bytes]
    client: ["client", server_name, port, n_downloads]
"""

from __future__ import annotations

from .registry import register


@register("filetransfer")
def main(api, args):
    role = args[0] if args else "server"
    if role == "server":
        port = int(args[1]) if len(args) > 1 else 80
        size = int(args[2]) if len(args) > 2 else 16384
        yield from _server(api, port, size)
        return 0
    server = args[1] if len(args) > 1 else "server"
    port = int(args[2]) if len(args) > 2 else 80
    n = int(args[3]) if len(args) > 3 else 1
    ok = yield from _client(api, server, port, n)
    return 0 if ok else 1


def _server(api, port, size):
    lfd = api.socket("tcp")
    api.bind(lfd, ("0.0.0.0", port))
    api.listen(lfd)
    api.log(f"filetransfer server on :{port}, file size {size}")
    while True:
        cfd, _peer = yield from api.accept(lfd)
        api.spawn(_serve_one, api, cfd, size)


def _serve_one(api, fd, size):
    # request = one line; response = 8-byte big-endian length + payload
    req = yield from api.recv(fd, 4096)
    if not req:
        api.close(fd)
        return
    payload = b"x" * size
    yield from api.send(fd, len(payload).to_bytes(8, "big") + payload)
    api.close(fd)


def _client(api, server, port, n):
    total_ok = 0
    for i in range(n):
        fd = api.socket("tcp")
        yield from api.connect(fd, (server, port))
        yield from api.send(fd, b"GET\n")
        hdr = b""
        while len(hdr) < 8:
            chunk = yield from api.recv(fd, 8 - len(hdr))
            if not chunk:
                break
            hdr += chunk
        if len(hdr) < 8:
            api.close(fd)
            continue
        want = int.from_bytes(hdr, "big")
        got = 0
        while got < want:
            chunk = yield from api.recv(fd, 65536)
            if not chunk:
                break
            got += len(chunk)
        if got == want:
            total_ok += 1
        api.close(fd)
    api.log(f"filetransfer client: {total_ok}/{n} downloads ok")
    return total_ok == n
