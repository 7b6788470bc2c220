"""Bitcoin-like P2P block-gossip workload (capability analog of
shadow-plugin-bitcoin, BASELINE.md config #5: 5k-node gossip).

Models the network behavior of Bitcoin's block relay: every node keeps
long-lived TCP connections to a set of peers, miners periodically announce
new blocks via ``inv`` messages, peers that haven't seen a block request it
with ``getdata``, receive the full ``block`` bytes, and re-announce to their
own peers — the classic epidemic broadcast whose propagation latency is the
headline metric for this workload family.

Role:
    node <peer1,peer2,...|-> [mine <interval_sec> <block_bytes> <count>]
                             [txgen <interval_sec> <tx_bytes> <count>]
        Connects out to the listed peers (``-`` = none; inbound only) on
        port 8333 and serves inbound connections.  With ``mine``, creates
        <count> blocks every <interval_sec> seconds and announces them;
        with ``txgen``, originates <count> transactions the same way into
        every mempool.  The keywords combine: a node can both mine and
        originate transactions.

Wire format: length-prefixed messages ``u32 len | u8 type | payload``.
Types: INV (u64 block id), GETDATA (u64 block id), BLOCK (u64 id + bytes),
and the transaction-relay triple TXINV/GETTX/TX — the tx gossip that
dominates message counts on the real network (every node relays every
transaction into its peers' mempools the same epidemic way blocks travel).

``process.app_state`` exposes per-node stats (blocks known, bytes relayed,
per-block first-seen virtual time) for tests and benchmark reporting.
"""

from __future__ import annotations

import struct

from .registry import register

PORT = 8333
MSG_HDR = struct.Struct(">IB")
INV = 1
GETDATA = 2
BLOCK = 3
TXINV = 4
GETTX = 5
TX = 6


class NodeState:
    def __init__(self):
        self.blocks = {}            # block_id -> size
        self.requested = set()      # getdata in flight (bitcoind tracks
                                    # in-flight blocks per peer the same way)
        self.first_seen_ns = {}     # block_id -> virtual ns
        self.peers = []             # connected peer fds
        self.bytes_relayed = 0
        self.mined = 0
        # transaction relay (mempool)
        self.mempool = {}           # tx_id -> size
        self.tx_requested = set()
        self.tx_first_seen_ns = {}
        self.txs_originated = 0


def _pack(msg_type: int, payload: bytes) -> bytes:
    return MSG_HDR.pack(len(payload) + 1, msg_type) + payload


def recv_msg(api, fd):
    hdr = yield from api.recv_exact(fd, MSG_HDR.size)
    if hdr is None:
        return None
    length, msg_type = MSG_HDR.unpack(hdr)
    payload = b""
    if length > 1:
        payload = yield from api.recv_exact(fd, length - 1)
        if payload is None:
            return None
    return msg_type, payload


@register("bitcoin")
def main(api, args):
    st = NodeState()
    api.process.app_state = st
    peers = [] if not args or args[0] in ("-", "") else args[0].split(",")
    mine_every = mine_size = mine_count = 0
    tx_every = tx_size = tx_count = 0
    rest = list(args[1:])
    while rest:
        kw = rest.pop(0)
        if kw in ("mine", "txgen"):
            if len(rest) < 2:
                raise ValueError(f"bitcoin: {kw} needs <interval> <bytes>")
            every = float(rest.pop(0))
            size = int(rest.pop(0))
            count = int(rest.pop(0)) if rest and rest[0].isdigit() else 1
            if kw == "mine":
                mine_every, mine_size, mine_count = every, size, count
            else:
                tx_every, tx_size, tx_count = every, size, count
        else:
            raise ValueError(f"bitcoin: unknown argument {kw!r}")

    lfd = api.socket("tcp")
    api.bind(lfd, ("0.0.0.0", PORT))
    api.listen(lfd, 125)  # bitcoind's default max connections
    api.spawn(_accept_loop, api, st, lfd)

    for peer in peers:
        api.spawn(_dial, api, st, peer)

    if mine_every > 0:
        api.spawn(_miner, api, st, mine_every, mine_size, mine_count)
    if tx_every > 0:
        api.spawn(_txgen, api, st, tx_every, tx_size, tx_count)

    # the node runs until the simulation stops it
    while True:
        yield from api.sleep(3600)


def _accept_loop(api, st, lfd):
    while True:
        cfd, _ = yield from api.accept(lfd)
        st.peers.append(cfd)
        api.spawn(_inbound_peer, api, st, cfd)


def _inbound_peer(api, st, fd):
    # exchange must be two-way: a late joiner's inbound link is its only
    # path to blocks/txs known before the link formed
    for block_id in list(st.blocks):
        yield from api.send(fd, _pack(INV, struct.pack(">Q", block_id)))
    for tx_id in list(st.mempool):
        yield from api.send(fd, _pack(TXINV, struct.pack(">Q", tx_id)))
    yield from _peer_loop(api, st, fd)


def _dial(api, st, peer):
    """Dial with retry: peers boot in staggered waves, so the first attempts
    can hit a not-yet-listening node (bitcoind retries its addrman the same
    way); give up only after the overlay has clearly had time to form."""
    fd = None
    for attempt in range(12):
        fd = api.socket("tcp")
        try:
            yield from api.connect(fd, (peer, PORT))
            break
        except OSError:
            api.close(fd)
            fd = None
            yield from api.sleep(5 * (attempt + 1))
    if fd is None:
        api.log(f"bitcoin: dial {peer} failed permanently")
        return
    st.peers.append(fd)
    # announce everything we already know (block + tx exchange on connect)
    for block_id in list(st.blocks):
        yield from api.send(fd, _pack(INV, struct.pack(">Q", block_id)))
    for tx_id in list(st.mempool):
        yield from api.send(fd, _pack(TXINV, struct.pack(">Q", tx_id)))
    yield from _peer_loop(api, st, fd)


def _peer_loop(api, st, fd):
    inflight = set()  # getdata sent on THIS connection, block not yet seen
    tx_inflight = set()
    while True:
        msg = yield from recv_msg(api, fd)
        if msg is None:
            break
        msg_type, payload = msg
        if msg_type == INV:
            (block_id,) = struct.unpack(">Q", payload)
            if block_id not in st.blocks and block_id not in st.requested:
                st.requested.add(block_id)
                inflight.add(block_id)
                yield from api.send(fd, _pack(GETDATA, payload))
        elif msg_type == GETDATA:
            (block_id,) = struct.unpack(">Q", payload)
            size = st.blocks.get(block_id)
            if size is not None:
                body = struct.pack(">Q", block_id) + b"\0" * size
                st.bytes_relayed += len(body)
                yield from api.send(fd, _pack(BLOCK, body))
        elif msg_type == BLOCK:
            (block_id,) = struct.unpack(">Q", payload[:8])
            st.requested.discard(block_id)
            inflight.discard(block_id)
            if block_id not in st.blocks:
                _learn_block(api, st, block_id, len(payload) - 8)
                yield from _announce(api, st, block_id, exclude=fd)
        elif msg_type == TXINV:
            (tx_id,) = struct.unpack(">Q", payload)
            if tx_id not in st.mempool and tx_id not in st.tx_requested:
                st.tx_requested.add(tx_id)
                tx_inflight.add(tx_id)
                yield from api.send(fd, _pack(GETTX, payload))
        elif msg_type == GETTX:
            (tx_id,) = struct.unpack(">Q", payload)
            size = st.mempool.get(tx_id)
            if size is not None:
                body = struct.pack(">Q", tx_id) + b"\0" * size
                st.bytes_relayed += len(body)
                yield from api.send(fd, _pack(TX, body))
        elif msg_type == TX:
            (tx_id,) = struct.unpack(">Q", payload[:8])
            st.tx_requested.discard(tx_id)
            tx_inflight.discard(tx_id)
            if tx_id not in st.mempool:
                st.mempool[tx_id] = len(payload) - 8
                st.tx_first_seen_ns[tx_id] = api.now_ns()
                yield from _announce_tx(api, st, tx_id, exclude=fd)
    # a dead peer's undelivered getdata/gettx must not black-hole those
    # items: clear them so another peer's inv re-triggers the request
    # (sorted: set iteration order is hash-seed-dependent — SIM003)
    for block_id in sorted(inflight):
        if block_id not in st.blocks:
            st.requested.discard(block_id)
    for tx_id in sorted(tx_inflight):
        if tx_id not in st.mempool:
            st.tx_requested.discard(tx_id)
    if fd in st.peers:
        st.peers.remove(fd)
    api.close(fd)


def _learn_block(api, st, block_id, size):
    st.blocks[block_id] = size
    st.first_seen_ns[block_id] = api.now_ns()


def _broadcast(api, st, msg, exclude=None):
    """Send an announcement to every live peer but the one it came from
    (send failures mean the peer loop is tearing that fd down)."""
    for peer_fd in list(st.peers):
        if peer_fd == exclude:
            continue
        try:
            yield from api.send(peer_fd, msg)
        except OSError:
            pass


def _announce(api, st, block_id, exclude=None):
    yield from _broadcast(api, st, _pack(INV, struct.pack(">Q", block_id)),
                          exclude)


def _announce_tx(api, st, tx_id, exclude=None):
    yield from _broadcast(api, st, _pack(TXINV, struct.pack(">Q", tx_id)),
                          exclude)


def _txgen(api, st, every_sec, tx_size, count):
    """Originates transactions with globally-unique ids in a disjoint id
    space from blocks: (1 << 56) | (host_id << 20) | seq."""
    host_id = api.host.id
    for seq in range(count):
        yield from api.sleep(every_sec)
        tx_id = (1 << 56) | (host_id << 20) | seq
        st.mempool[tx_id] = tx_size
        st.tx_first_seen_ns[tx_id] = api.now_ns()
        st.txs_originated += 1
        yield from _announce_tx(api, st, tx_id)


def _miner(api, st, every_sec, block_size, count):
    """Creates blocks with globally-unique ids: (host_id << 20) | seq."""
    host_id = api.host.id
    for seq in range(count):
        yield from api.sleep(every_sec)
        block_id = (host_id << 20) | seq
        _learn_block(api, st, block_id, block_size)
        st.mined += 1
        api.log(f"bitcoin: mined block {block_id:#x} ({block_size}B)")
        yield from _announce(api, st, block_id)
