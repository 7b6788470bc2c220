"""Minimal deterministic HTTP/1.0 server — the in-sim peer for real HTTP
clients (wget/curl) running on the native plugin plane.

Args: [port, content_bytes]

Every GET is answered with ``content_bytes`` of a deterministic pattern and
``Connection: close`` framing, which is all wget/curl need to complete a
download whose byte count the test can assert against a native-run transfer
(the reference CI proves its interposition on real tgen/Tor the same way —
an unmodified binary moving real bytes through the simulated network).
"""

from __future__ import annotations

from .registry import register


def _body(n: int) -> bytes:
    pat = b"0123456789abcdef" * 64   # 1 KiB deterministic block
    reps = n // len(pat) + 1
    return (pat * reps)[:n]


@register("httpd")
def main(api, args):
    port = int(args[0]) if args else 80
    nbytes = int(args[1]) if len(args) > 1 else 65536
    body = _body(nbytes)
    head = (b"HTTP/1.0 200 OK\r\n"
            b"Content-Type: application/octet-stream\r\n"
            b"Content-Length: " + str(nbytes).encode() + b"\r\n"
            b"Connection: close\r\n\r\n")
    lfd = api.socket("tcp")
    api.bind(lfd, ("0.0.0.0", port))
    api.listen(lfd, 16)
    api.log(f"httpd on :{port}, {nbytes}B per GET")
    served = 0
    while True:
        cfd, _addr = yield from api.accept(lfd)
        # read until the blank line ending the request head
        req = b""
        while b"\r\n\r\n" not in req and len(req) < 65536:
            chunk = yield from api.recv(cfd, 4096)
            if not chunk:
                break
            req += chunk
        if req.startswith(b"GET") or req.startswith(b"HEAD"):
            payload = head if req.startswith(b"HEAD") else head + body
            yield from api.send(cfd, payload)
        api.shutdown(cfd, 1)
        # drain the client's half-close so TIME_WAIT bookkeeping is clean
        while True:
            tail = yield from api.recv(cfd, 4096)
            if not tail:
                break
        api.close(cfd)
        served += 1
        api.log(f"httpd served request #{served}")
