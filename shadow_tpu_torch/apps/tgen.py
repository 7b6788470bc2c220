"""tgen-like traffic generator (capability analog of the tgen plugin the
reference's example configs drive: resource/examples/shadow.config.xml).

Supported behaviors:
    server: ["server", port]                        — accepts streams, sinks
                                                      and/or serves bytes
    client: ["client", server, port, stream_spec...]
        stream_spec: "<send_bytes>:<recv_bytes>" per stream, executed
        sequentially (e.g. "1024:1048576" uploads 1 KiB then downloads 1 MiB
        — the classic tgen web-ish pattern).

Protocol: 16-byte header (8B send count from client, 8B requested bytes from
server), then raw bytes each way.
"""

from __future__ import annotations

from .registry import register


@register("tgen")
def main(api, args):
    role = args[0] if args else "server"
    if role == "server":
        port = int(args[1]) if len(args) > 1 else 80
        yield from _server(api, port)
        return 0
    device_mode = "device" in args
    if device_mode:
        args = [a for a in args if a != "device"]
    server = args[1]
    port = int(args[2]) if len(args) > 2 else 80
    specs = args[3:] if len(args) > 3 else ["1024:65536"]
    if device_mode:
        ok = yield from _client_device(api, server, port, specs)
    else:
        ok = yield from _client(api, server, port, specs)
    return 0 if ok else 1


def _server(api, port):
    lfd = api.socket("tcp")
    api.bind(lfd, ("0.0.0.0", port))
    api.listen(lfd)
    api.log(f"tgen server on :{port}")
    while True:
        cfd, _ = yield from api.accept(lfd)
        api.spawn(_serve_stream, api, cfd)


def _serve_stream(api, fd):
    hdr = b""
    while len(hdr) < 16:
        chunk = yield from api.recv(fd, 16 - len(hdr))
        if not chunk:
            api.close(fd)
            return
        hdr += chunk
    upload = int.from_bytes(hdr[:8], "big")
    download = int.from_bytes(hdr[8:], "big")
    got = 0
    while got < upload:
        chunk = yield from api.recv(fd, 65536)
        if not chunk:
            api.close(fd)
            return
        got += len(chunk)
    sent = 0
    while sent < download:
        n = min(65536, download - sent)
        yield from api.send(fd, b"d" * n)
        sent += n
    api.close(fd)


def _client_device(api, server, port, specs):
    """Device-plane bulk: the control plane still runs — a real TCP
    connect + the tgen header handshake (0:0, so the server serves nothing
    and closes) — then the bulk bytes advance in HBM
    (parallel/device_plane.py) and the client blocks until the plane
    reports completion."""
    fd = api.socket("tcp")
    yield from api.connect(fd, (server, port))
    yield from api.send(fd, (0).to_bytes(8, "big") + (0).to_bytes(8, "big"))
    api.close(fd)
    handle = api.device_flow_start(route=[server])
    done_ns = yield from api.device_flow_join(handle)
    total_down = sum(int(s.partition(":")[2] or 0) for s in specs)
    api.log(f"tgen client device flow complete at {done_ns / 1e9:.3f}s "
            f"({total_down}B down, {len(specs)} streams)")
    return True


def _client(api, server, port, specs):
    ok = True
    for spec in specs:
        up_s, _, down_s = spec.partition(":")
        upload, download = int(up_s), int(down_s or 0)
        fd = api.socket("tcp")
        yield from api.connect(fd, (server, port))
        yield from api.send(fd, upload.to_bytes(8, "big") + download.to_bytes(8, "big"))
        sent = 0
        while sent < upload:
            n = min(65536, upload - sent)
            yield from api.send(fd, b"u" * n)
            sent += n
        got = 0
        while got < download:
            chunk = yield from api.recv(fd, 65536)
            if not chunk:
                break
            got += len(chunk)
        if got != download:
            ok = False
        api.close(fd)
    api.log(f"tgen client finished {len(specs)} streams ok={ok}")
    return ok
