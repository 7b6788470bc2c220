"""Tor-like onion-relay workload (capability analog of shadow-plugin-tor,
the reference's flagship workload: BASELINE.md configs #3/#4).

Models the *network behavior* of a Tor overlay — fixed 512-byte cells,
multi-hop circuits built with EXTEND handshakes, stream multiplexing over
circuits, exit-side TCP to the destination — without the cryptography
(the reference's plugin runs real Tor; what the simulator measures is the
traffic pattern, which this reproduces: per-hop store-and-forward of cells
over long-lived TCP connections).

Roles:
    relay <orport>
        Accepts OR connections, creates/extends circuits, relays cells.
    client <socksport> <path> <dest> <destport> <nstreams> <up:down> [...]
        <path> = comma-separated relay hostnames (guard,middle,exit).
        Builds one circuit through <path>, then runs <nstreams> sequential
        streams to <dest>:<destport>, each uploading `up` bytes and
        downloading `down` bytes (tgen-style).
    server <port>
        Destination: tgen-protocol byte sink/source.

Cell format (fixed CELL_SIZE bytes on the wire):
    u32 circ_id | u8 cmd | u16 len | payload (padded)

Commands: CREATE/CREATED (one-hop handshake), EXTEND/EXTENDED (grow the
circuit by one hop), BEGIN/CONNECTED (open exit stream), DATA, END.
"""

from __future__ import annotations

import struct

from .registry import register

CELL_SIZE = 512
HDR = struct.Struct(">IBH")
PAYLOAD_MAX = CELL_SIZE - HDR.size

CREATE = 1
CREATED = 2
EXTEND = 3
EXTENDED = 4
BEGIN = 5
CONNECTED = 6
DATA = 7
END = 8


def make_cell(circ_id: int, cmd: int, payload: bytes = b"") -> bytes:
    assert len(payload) <= PAYLOAD_MAX
    return HDR.pack(circ_id, cmd, len(payload)) + payload.ljust(PAYLOAD_MAX, b"\0")


def parse_cell(cell: bytes):
    circ_id, cmd, plen = HDR.unpack(cell[:HDR.size])
    return circ_id, cmd, cell[HDR.size:HDR.size + plen]


def recv_cell(api, fd):
    cell = yield from api.recv_exact(fd, CELL_SIZE)
    if cell is None:
        return None
    return parse_cell(cell)


@register("tor")
def main(api, args):
    role = args[0] if args else "relay"
    if role == "relay":
        # relay <orport> [<dirauth_host:port> <bw_weight>]: with a dirauth,
        # the relay publishes its descriptor after opening the ORPort (real
        # Tor also listens before uploading its descriptor, so the
        # consensus never advertises a closed port)
        orport = int(args[1]) if len(args) > 1 else 9001
        dirspec = args[2] if len(args) > 2 else None
        bw = int(args[3]) if len(args) > 3 else 100
        yield from relay_main(api, orport, dirspec, bw)
        return 0
    if role == "server":
        yield from server_main(api, int(args[1]) if len(args) > 1 else 80)
        return 0
    if role == "client":
        ok = yield from client_main(api, args[1:])
        return 0 if ok else 1
    if role == "dirauth":
        yield from dirauth_main(api, int(args[1]) if len(args) > 1 else 9030)
        return 0
    raise ValueError(f"tor: unknown role {role!r}")


# ---------------------------------------------------------------------------
# directory authority (v3 dirauth network behavior: relays upload
# descriptors, clients fetch the consensus and weight their path selection
# by advertised bandwidth — the bootstrap phase real Tor networks start
# with; the crypto/voting among authorities is out of model scope)
# ---------------------------------------------------------------------------

def publish_descriptor(api, dirspec, orport, bw_weight):
    host, _, port = dirspec.partition(":")
    fd = api.socket("tcp")
    yield from api.connect(fd, (host, int(port or 9030)))
    line = f"r {api.host.name} {orport} {bw_weight}\n".encode()
    yield from api.send(fd, line)
    api.close(fd)


def dirauth_main(api, port):
    relays = {}          # name -> (orport, bw)
    api.process.app_state = relays
    lfd = api.socket("tcp")
    api.bind(lfd, ("0.0.0.0", port))
    api.listen(lfd, 64)
    api.log(f"tor dirauth on :{port}")
    while True:
        cfd, _ = yield from api.accept(lfd)
        api.spawn(_dirauth_conn, api, relays, cfd)


def _dirauth_conn(api, relays, fd):
    buf = b""
    while b"\n" not in buf:
        data = yield from api.recv(fd, 4096)
        if not data:
            api.close(fd)
            return
        buf += data
    line = buf.split(b"\n", 1)[0].decode()
    if line.startswith("r "):
        _, name, orport, bw = line.split()
        relays[name] = (int(orport), int(bw))
    elif line.startswith("GETCONS"):
        # deterministic consensus: sorted by relay name
        doc = "".join(f"r {n} {p} {w}\n"
                      for n, (p, w) in sorted(relays.items()))
        yield from api.send(fd, doc.encode() + b".\n")
    api.close(fd)


def fetch_consensus(api, dirspec):
    """Client-side bootstrap: fetch and parse the consensus."""
    host, _, port = dirspec.partition(":")
    fd = api.socket("tcp")
    yield from api.connect(fd, (host, int(port or 9030)))
    yield from api.send(fd, b"GETCONS\n")
    buf = b""
    complete = False
    while True:
        if buf.endswith(b".\n"):
            complete = True
            break
        data = yield from api.recv(fd, 65536)
        if not data:
            break
        buf += data
    api.close(fd)
    if not complete:
        # truncated document (authority died mid-send): fail the bootstrap
        # loudly rather than route over a silently partial consensus
        return []
    relays = []
    for line in buf.decode().splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "r":
            relays.append((parts[1], int(parts[2]), int(parts[3])))
    return relays


def pick_weighted(rng, relays, n_hops=3):
    """Bandwidth-weighted selection without replacement from an explicit
    RandomSource.  Shared by the runtime client AND the device plane's
    startup path prediction (parallel/device_plane.py replays the same
    draws from the same derived stream)."""
    pool = list(relays)
    path = []
    for _ in range(min(n_hops, len(pool))):
        total = sum(w for _n, _p, w in pool)
        draw = rng.next_int(max(total, 1))
        acc = 0
        for i, (name, orport, w) in enumerate(pool):
            acc += w
            if draw < acc:
                path.append((name, orport))
                pool.pop(i)
                break
        else:
            path.append(pool[-1][:2])
            pool.pop()
    return path


def pick_path(api, relays, n_hops=3):
    """Bandwidth-weighted path selection without replacement, drawn from
    the HOST's deterministic RNG (per-host stream: identical across
    scheduler policies, so digests stay parity-comparable)."""
    return pick_weighted(api.host.random, relays, n_hops)


# ---------------------------------------------------------------------------
# relay
# ---------------------------------------------------------------------------

class _RelayState:
    """Per-relay circuit switchboard.

    circuits maps (conn_fd, circ_id) -> ("fwd", out_fd, out_circ_id) for a
    spliced middle hop, or ("exit", stream_fd) once the exit stream is open.
    """

    def __init__(self):
        self.circuits = {}
        self.next_circ_id = 1
        self.cells_relayed = 0


def relay_main(api, orport, dirspec=None, bw_weight=100):
    st = _RelayState()
    api.process.app_state = st
    lfd = api.socket("tcp")
    api.bind(lfd, ("0.0.0.0", orport))
    api.listen(lfd, 64)
    api.log(f"tor relay on :{orport}")
    if dirspec:
        yield from publish_descriptor(api, dirspec, orport, bw_weight)
    while True:
        cfd, _ = yield from api.accept(lfd)
        api.spawn(_relay_conn, api, st, cfd)


def _relay_conn(api, st, fd):
    """Serve one inbound OR connection: each cell either manages a circuit
    or is relayed to the next hop / exit stream."""
    while True:
        parsed = yield from recv_cell(api, fd)
        if parsed is None:
            break
        circ_id, cmd, payload = parsed
        key = (fd, circ_id)
        if cmd == CREATE:
            st.circuits[key] = None  # endpoint of the circuit so far
            yield from api.send(fd, make_cell(circ_id, CREATED))
        elif cmd == EXTEND:
            route = st.circuits.get(key)
            if route is not None and route[0] == "fwd":
                # already spliced: the EXTEND is for a later hop — relay it
                # down the circuit (real Tor extends end-to-end the same way)
                _, out, out_circ = route
                yield from api.send(out,
                                    make_cell(out_circ, EXTEND, payload))
                continue
            # we are the current endpoint: connect onward, splice
            target = payload.decode()
            host, _, port = target.partition(":")
            out = api.socket("tcp")
            try:
                yield from api.connect(out, (host, int(port)))
            except OSError:
                yield from api.send(fd, make_cell(circ_id, END))
                continue
            out_circ = st.next_circ_id
            st.next_circ_id += 1
            yield from api.send(out, make_cell(out_circ, CREATE))
            reply = yield from recv_cell(api, out)
            if reply is None or reply[1] != CREATED:
                yield from api.send(fd, make_cell(circ_id, END))
                continue
            st.circuits[key] = ("fwd", out, out_circ)
            api.spawn(_relay_backward, api, st, out, out_circ, fd, circ_id)
            yield from api.send(fd, make_cell(circ_id, EXTENDED))
        elif cmd in (BEGIN, DATA, END):
            route = st.circuits.get(key)
            if cmd == BEGIN and (route is None or route[0] == "exit"):
                # we are the exit: open (or reopen, for the next sequential
                # stream on this circuit) the destination stream
                target = payload.decode()
                host, _, port = target.partition(":")
                sfd = api.socket("tcp")
                try:
                    yield from api.connect(sfd, (host, int(port)))
                except OSError:
                    yield from api.send(fd, make_cell(circ_id, END))
                    continue
                st.circuits[key] = ("exit", sfd)
                api.spawn(_exit_backward, api, st, key, sfd, fd, circ_id)
                yield from api.send(fd, make_cell(circ_id, CONNECTED))
            elif route is not None and route[0] == "fwd":
                _, out, out_circ = route
                st.cells_relayed += 1
                yield from api.send(out, make_cell(out_circ, cmd, payload))
            elif route is not None and route[0] == "exit":
                _, sfd = route
                if cmd == DATA:
                    st.cells_relayed += 1
                    yield from api.send(sfd, payload)
                elif cmd == END:
                    api.close(sfd)
                    st.circuits.pop(key, None)
    api.close(fd)


def _relay_backward(api, st, out, out_circ, fd, circ_id):
    """Pump cells arriving from the next hop back down the circuit."""
    while True:
        parsed = yield from recv_cell(api, out)
        if parsed is None:
            break
        in_circ, cmd, payload = parsed
        if in_circ != out_circ:
            continue
        st.cells_relayed += 1
        yield from api.send(fd, make_cell(circ_id, cmd, payload))


def _exit_backward(api, st, key, sfd, fd, circ_id):
    """Exit side: wrap destination bytes into DATA cells toward the client."""
    while True:
        data = yield from api.recv(sfd, PAYLOAD_MAX)
        if not data:
            break
        st.cells_relayed += 1
        yield from api.send(fd, make_cell(circ_id, DATA, data))
    # destination closed: clear the route so the next BEGIN can reopen
    if st.circuits.get(key) == ("exit", sfd):
        st.circuits[key] = None
    api.close(sfd)
    yield from api.send(fd, make_cell(circ_id, END))


# ---------------------------------------------------------------------------
# destination server (tgen protocol: 16B header, raw bytes both ways)
# ---------------------------------------------------------------------------

def server_main(api, port):
    lfd = api.socket("tcp")
    api.bind(lfd, ("0.0.0.0", port))
    api.listen(lfd, 64)
    api.log(f"tor destination server on :{port}")
    while True:
        cfd, _ = yield from api.accept(lfd)
        api.spawn(_serve_one, api, cfd)


def _serve_one(api, fd):
    hdr = yield from api.recv_exact(fd, 16)
    if hdr is None:
        api.close(fd)
        return
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
    blob = b"x" * 65536
    while sent < download:
        n = min(len(blob), download - sent)
        yield from api.send(fd, blob[:n])
        sent += n
    api.close(fd)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class _ClientStats:
    def __init__(self):
        self.streams_ok = 0
        self.bytes_up = 0
        self.bytes_down = 0


def client_main(api, args):
    # args: <socksport> <path> <dest> <destport> <nstreams> <spec...>
    #       [device]
    # path entries are "relayhost" or "relayhost:orport" (default 9001,
    # matching the relay role's default), OR "auto:<dirhost>:<dirport>" to
    # bootstrap like real Tor: fetch the consensus from the directory
    # authority and pick a bandwidth-weighted 3-hop path.
    # The trailing "device" flag promotes the DATA phase to the
    # device-resident traffic plane: the circuit is still built through the
    # real engine (TCP + CREATE/EXTEND through real relays), then the bulk
    # download advances in HBM (parallel/device_plane.py) and the client
    # blocks until the plane reports completion.
    device_mode = "device" in args
    if device_mode:
        args = [a for a in args if a != "device"]
    if args[1].startswith("auto:"):
        # "auto:<dirhost>" or "auto:<dirhost>:<dirport>" (default 9030,
        # same optional-port convention as relay specs)
        consensus = yield from fetch_consensus(api, args[1][len("auto:"):])
        if not consensus:
            api.log("tor client: empty consensus")
            return False
        if device_mode:
            # device plane: draw from a DERIVED stream (order-independent)
            # so the plane can predict this exact path at startup from the
            # config-determined consensus (parallel/device_plane.py); the
            # consensus fetch above still exercised the real TCP bootstrap
            path = pick_weighted(api.host.random.spawn("device-circuit"),
                                 consensus)
        else:
            path = pick_path(api, consensus)
        api.log(f"tor client: consensus has {len(consensus)} relays, "
                f"picked {'->'.join(h for h, _ in path)}")
    else:
        path = [(h.partition(":")[0], int(h.partition(":")[2] or 9001))
                for h in args[1].split(",")]
    dest, destport = args[2], int(args[3])
    nstreams = int(args[4]) if len(args) > 4 else 1
    specs = args[5:] if len(args) > 5 else ["100:10000"]
    stats = _ClientStats()
    api.process.app_state = stats

    # build the circuit: connect to the guard, CREATE, then EXTEND per hop
    guard, guard_port = path[0]
    fd = api.socket("tcp")
    yield from api.connect(fd, (guard, guard_port))
    circ = 1
    yield from api.send(fd, make_cell(circ, CREATE))
    reply = yield from recv_cell(api, fd)
    if reply is None or reply[1] != CREATED:
        api.log("tor client: CREATE failed")
        return False
    for hop, hop_port in path[1:]:
        yield from api.send(fd,
                            make_cell(circ, EXTEND, f"{hop}:{hop_port}".encode()))
        reply = yield from recv_cell(api, fd)
        if reply is None or reply[1] != EXTENDED:
            api.log(f"tor client: EXTEND to {hop} failed")
            return False
    api.log(f"tor client: circuit built through {'->'.join(h for h, _ in path)}")

    if device_mode:
        # control plane done — hand the bulk transfer to the device plane
        # (the route cross-check catches a consensus-prediction divergence
        # for auto: clients; static paths trivially match)
        handle = api.device_flow_start(route=[h for h, _p in path])
        done_ns = yield from api.device_flow_join(handle)
        for i in range(nstreams):
            spec = specs[i % len(specs)]
            up, down = (int(x) for x in spec.split(":"))
            stats.streams_ok += 1
            stats.bytes_up += up
            stats.bytes_down += down
        yield from api.send(fd, make_cell(circ, END))
        api.close(fd)
        api.log(f"tor client: device flow complete at "
                f"{done_ns / 1e9:.3f}s ({stats.bytes_down}B down, "
                f"{stats.streams_ok} streams)")
        return True

    for i in range(nstreams):
        spec = specs[i % len(specs)]
        up, down = (int(x) for x in spec.split(":"))
        ok = yield from _run_stream(api, fd, circ, dest, destport, up, down)
        if not ok:
            return False
        stats.streams_ok += 1
        stats.bytes_up += up
        stats.bytes_down += down
    yield from api.send(fd, make_cell(circ, END))
    api.close(fd)
    api.log(f"tor client: {stats.streams_ok} streams OK "
            f"({stats.bytes_up}B up, {stats.bytes_down}B down)")
    return True


def _run_stream(api, fd, circ, dest, destport, up, down):
    yield from api.send(fd,
                        make_cell(circ, BEGIN, f"{dest}:{destport}".encode()))
    reply = yield from recv_cell(api, fd)
    if reply is None or reply[1] != CONNECTED:
        return False
    # tgen header through the tunnel
    hdr = up.to_bytes(8, "big") + down.to_bytes(8, "big")
    body = hdr + b"u" * up
    for off in range(0, len(body), PAYLOAD_MAX):
        yield from api.send(fd,
                            make_cell(circ, DATA, body[off:off + PAYLOAD_MAX]))
    got = 0
    ended = False
    while got < down:
        reply = yield from recv_cell(api, fd)
        if reply is None:
            return False
        _, cmd, payload = reply
        if cmd == END:
            ended = True
            break
        if cmd == DATA:
            got += len(payload)
    # drain the exit's END so it can't be mistaken for the next stream's
    # CONNECTED reply (streams run sequentially on one circuit)
    while not ended:
        reply = yield from recv_cell(api, fd)
        if reply is None:
            return False
        if reply[1] == END:
            ended = True
    return got >= down
