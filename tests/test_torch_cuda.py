"""The port's CUDA kernels on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these tests skip where there is no GPU or
no nvcc, with the reason; on a machine with an H100 they run with
``python -m pytest tests/test_torch_cuda.py``.  They hold each kernel
(packet_hop, torcells_span, pack_flush) bit-exact against its plain torch
version on the same card tensors (the span kernel also on a table with
nodes longer than its tiles and chunks, and a skewed one), check the hop's
async launch path (pinned buffers, own stream, several chunks pending at
once) and the wrappers' argument checks, run the small tor configs (with
and without device-mode clients) end to end on the card against the port's
CPU run, and check that a failed launch of the device plane ends the run
instead of demoting it.
The mesh's kernels (mesh_span, the mesh flush, the sharded hop in both
layouts) are held the same way, and the small tor config on D shards of the
card equals its CPU run, with every dispatch through the mesh kernels.
The model kernels are held on small instances and, for saturate and
admit_sorted, on chip_smoke.py's edge cases.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu_torch.ops import round_step as rs

pytestmark = pytest.mark.cuda

A = 183
DROP_KEY = 0x0123456789ABCDEF
BOOTSTRAP_END = 2_000_000_000


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from shadow_tpu_torch.ops import _build
    try:
        _build.nvcc_path()
    except RuntimeError as e:
        pytest.skip(f"needs nvcc to build the kernel: {e}")
    return torch.device("cuda", 0)


def _case(b, n, seed, device):
    rng = np.random.default_rng(seed)
    lat = rng.integers(1_000_000, 90_000_000, size=(A, A), dtype=np.int64)
    rel = rng.random((A, A)).astype(np.float32)
    pick = rng.random((A, A))
    rel[pick < 0.3] = 1.0
    rel[(pick >= 0.3) & (pick < 0.4)] = 0.0
    cols = (rng.integers(0, A, size=n, dtype=np.int32),
            rng.integers(0, A, size=n, dtype=np.int32),
            rng.integers(0, 2 ** 64, size=n, dtype=np.uint64),
            rng.integers(0, 2 * BOOTSTRAP_END, size=n, dtype=np.int64),
            BOOTSTRAP_END + 40_000_000)
    kern = rs.PacketHopKernel.from_arrays(lat, rel, DROP_KEY, BOOTSTRAP_END,
                                          device)
    packed = torch.from_numpy(kern._pack(*cols[:4], b, cols[4])).to(device)
    return kern, packed, cols


@pytest.mark.parametrize("b,n", [(1, 1), (256, 200), (257, 257),
                                 (512, 448), (65536, 60000)])
def test_kernel_bit_exact_vs_plain_version_on_card(dev, b, n):
    kern, packed, cols = _case(b, n, seed=b + n, device=dev)
    args = (kern.latency, kern.reliability, packed, kern.key_lo, kern.key_hi,
            kern.bootstrap_end_ns)
    before = rs.packet_hop_packed.launches
    d, k = rs.packet_hop_packed(*args)
    assert rs.packet_hop_packed.launches == before + 1
    rd, rk = rs.packet_hop_packed_reference(*args)
    torch.cuda.synchronize()
    assert d.device == dev and d.dtype == torch.int64 and k.dtype == torch.bool
    assert torch.equal(d, rd) and torch.equal(k, rk)
    nd, nk = kern._step_numpy(*cols)
    np.testing.assert_array_equal(d.cpu().numpy()[:n], nd)
    np.testing.assert_array_equal(k.cpu().numpy()[:n], nk)
    assert not k[n:].any()


def test_many_pending_launches_keep_their_buffers(dev):
    kern, _packed, _cols = _case(512, 300, seed=9, device=dev)
    rng = np.random.default_rng(10)
    batches = []
    for i in range(12):
        n = int(rng.integers(1, 700))
        batches.append((rng.integers(0, A, size=n, dtype=np.int32),
                        rng.integers(0, A, size=n, dtype=np.int32),
                        rng.integers(0, 2 ** 64, size=n, dtype=np.uint64),
                        rng.integers(0, 2 * BOOTSTRAP_END, size=n,
                                     dtype=np.int64), 1000 * i))
    handles = [kern.launch(*b) for b in batches]
    assert kern.device_calls == 12 and kern.host_calls == 0
    for h, b in reversed(list(zip(handles, batches))):
        d, k = h.wait()
        nd, nk = kern._step_numpy(*b)
        np.testing.assert_array_equal(d, nd)
        np.testing.assert_array_equal(k, nk)


@pytest.mark.parametrize("b,n", [(1, 1), (256, 200), (257, 257),
                                 (512, 448), (8192, 8000)])
def test_kernel_on_a_host_resident_round_bit_exact(dev, b, n):
    kern, packed, _cols = _case(b, n, seed=3 * b + n, device=dev)
    bufs = rs.MappedRound.allocate(b, dev)
    for round_ in range(2):               # fresh, then reused buffers
        if round_:
            _k, packed, _c = _case(b, n, seed=b + 7, device=dev)
        bufs.packed.copy_(packed.cpu())
        before = rs.packet_hop_mapped.launches
        rs.packet_hop_mapped(kern.latency, kern.reliability, bufs,
                             kern.key_lo, kern.key_hi, kern.bootstrap_end_ns)
        assert rs.packet_hop_mapped.launches == before + 1
        torch.cuda.synchronize()
        rd, rk = rs.packet_hop_packed_reference(
            kern.latency, kern.reliability, packed, kern.key_lo,
            kern.key_hi, kern.bootstrap_end_ns)
        assert torch.equal(bufs.deliver, rd.cpu())
        assert torch.equal(bufs.keep, rk.cpu())


def test_mapped_round_refuses_unmapped_buffers_by_name(dev):
    b = 256
    pinned = dict(packed=torch.empty((1 + b, 3), dtype=torch.int64,
                                     pin_memory=True),
                  deliver=torch.empty(b, dtype=torch.int64, pin_memory=True),
                  keep=torch.empty(b, dtype=torch.bool, pin_memory=True))
    rs.MappedRound(**pinned, device=dev)
    for name in ("deliver", "keep"):
        t = pinned[name]
        args = dict(pinned, **{name: torch.empty(t.shape, dtype=t.dtype)})
        with pytest.raises(ValueError, match=f"{name} is not page-locked"):
            rs.MappedRound(**args, device=dev)
    # page-locked, but 8 bytes off the kernel's 16-byte reads
    flat = torch.empty(3 * (1 + b) + 1, dtype=torch.int64, pin_memory=True)
    args = dict(pinned, packed=flat[1:].view(1 + b, 3))
    with pytest.raises(ValueError, match="packed must be 16-byte aligned"):
        rs.MappedRound(**args, device=dev)
    kern, _packed, _cols = _case(256, 10, seed=1, device=dev)
    with pytest.raises(TypeError, match="MappedRound"):
        rs.packet_hop_mapped(kern.latency, kern.reliability,
                             tuple(pinned.values()), kern.key_lo,
                             kern.key_hi, kern.bootstrap_end_ns)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    kern, packed, _cols = _case(256, 10, seed=1, device=dev)
    good = (kern.latency, kern.reliability, packed)
    rest = (kern.key_lo, kern.key_hi, kern.bootstrap_end_ns)
    bad = [
        (kern.latency.int(), kern.reliability, packed),
        (kern.latency, kern.reliability.double(), packed),
        (kern.latency, kern.reliability, packed.int()),
        (kern.latency, kern.reliability, packed[:, :2]),
        (kern.latency.t(), kern.reliability, packed),
        (kern.latency.cpu(), kern.reliability, packed),
        # contiguous, but 8 bytes off the kernel's 16-byte reads
        (kern.latency, kern.reliability, torch.cat(
            [packed.new_zeros(1), packed.flatten()])[1:].view(packed.shape)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            rs.packet_hop_packed(*args, *rest)
    rs.packet_hop_packed(*good, *rest)
    torch.cuda.synchronize()


@pytest.mark.parametrize("extra", [{}, {"workers": 2}, {"tpu_chunk": 1}])
def test_small_tor_on_card_equals_cpu_run(dev, extra):
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
    from shadow_tpu_torch.tools.workloads import tor_network

    def run(device):
        cfg = configuration.parse_xml(
            tor_network(10, n_clients=10, n_servers=2, stoptime=20))
        cfg.topology_text = lossy_complete_graphml(12, 3)
        ctl = Controller(Options(scheduler_policy="tpu", device=device,
                                 seed=11, stop_time_sec=20,
                                 log_level="warning", **extra), cfg)
        assert ctl.run() == 0
        e = ctl.engine
        kern = e.scheduler.policy._kernel
        return (state_digest(e), e.events_executed, e.rounds_executed,
                kern.device_calls, kern.host_calls)

    before = (rs.packet_hop_mapped.launches, rs.packet_hop_packed.launches)
    card = run("cuda")
    launched = rs.packet_hop_mapped.launches - before[0]
    cpu = run("cpu")
    assert card == cpu
    # every round on its host-resident buffers, none on device operands
    assert launched == card[3] > 0 and card[4] == 0
    assert rs.packet_hop_packed.launches == before[1]


@pytest.mark.parametrize("seed,idle,caps", [(0, 0, None), (1, 4, None),
                                            (2, 0, (3, 5)), (3, 0, (50, 50))])
def test_torcells_kernels_bit_exact_vs_plain_versions(dev, seed, idle, caps):
    from shadow_tpu_torch.ops import torcells_device as td
    from test_torch_torcells_cases import random_state, toy_instance
    inst = toy_instance()
    st = random_state(inst, seed)
    targets = 500 + 2 * np.arange(1, 9)
    zero = torch.zeros(inst["f"], dtype=torch.int64, device=dev)
    kw = dict(ring_len=inst["ring_len"],
              cap_chains=None if caps is None else caps[0],
              cap_nodes=None if caps is None else caps[1])
    s0, p0 = td.torcells_span.launches, td.pack_flush.launches
    state, tables = td.from_jax_state(st, inst["tables"], dev)
    got = td.torcells_step_window_flush(*state, zero, zero, targets, idle,
                                        *tables, **kw)
    assert (td.torcells_span.launches, td.pack_flush.launches) == \
        (s0 + 1, p0 + 1)
    state, tables = td.from_jax_state(st, inst["tables"], dev)
    want = td.torcells_step_window_flush_reference(
        *state, zero, zero, targets, idle, *tables, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.device == dev and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("targets", [[501], 500 + 3 * np.arange(1, 9)],
                         ids=["one tick", "eight boundaries"])
def test_torcells_span_kernel_with_a_queue_below_zero(dev, targets):
    """csrc/span_tile.cuh clips served as JAX does, max(., 0) then
    min(., q): a flow queued at -100 behind 10^6 cells of its node is
    served -100 (its queue 0 after one tick), as in the plain version."""
    from shadow_tpu_torch.ops import torcells_device as td
    from test_torch_torcells_cases import random_state, toy_instance
    inst = toy_instance()
    node_off = np.searchsorted(inst["tables"][0], np.arange(inst["h"] + 1))
    node = int(np.argmax(np.diff(node_off)))
    a, b = node_off[node], node_off[node] + 1
    st = list(random_state(inst, 5))
    st[1] = st[1].copy()
    st[1][a], st[1][b] = 10 ** 6, -100
    zero = torch.zeros(inst["f"], dtype=torch.int64, device=dev)
    targets = np.asarray(targets, dtype=np.int64)
    kw = dict(ring_len=inst["ring_len"])
    state, tables = td.from_jax_state(tuple(st), inst["tables"], dev)
    got = td.torcells_step_window_flush(*state, zero, zero, targets, 0,
                                        *tables, **kw)
    state, tables = td.from_jax_state(tuple(st), inst["tables"], dev)
    want = td.torcells_step_window_flush_reference(
        *state, zero, zero, targets, 0, *tables, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if len(targets) == 1:
        assert int(got[1][b]) == 0


@pytest.mark.parametrize("table", [(800, 4, 2.0), (2000, 150, 1.2)],
                         ids=["long node", "skewed"])
def test_torcells_kernels_bit_exact_on_long_and_skewed_tables(dev, table):
    """The span kernel on a table whose nodes run longer than a tile and
    the kernel's 512-flow chunk (~600 flows on each of 4 relays), and on a
    skewed one (a sweep lane's shape at a small size): bit-exact against
    the plain versions on all ten outputs."""
    from shadow_tpu_torch.ops import torcells_device as td
    from test_torch_torcells_cases import (injection, random_state,
                                           skewed_instance)
    inst = skewed_instance(*table)
    longest = int(np.bincount(inst["tables"][0]).max())
    assert table[1] != 4 or longest > td.CHUNK_FLOWS
    st = random_state(inst, 9)
    inj, inj_t = injection(inst, np.arange(0, inst["c"], 2), 40)
    targets = 500 + 3 * np.arange(1, 9)
    kw = dict(ring_len=inst["ring_len"])
    inj, inj_t = torch.as_tensor(inj, device=dev), torch.as_tensor(
        inj_t, device=dev)
    s0 = td.torcells_span.launches
    state, tables = td.from_jax_state(st, inst["tables"], dev)
    got = td.torcells_step_window_flush(*state, inj, inj_t, targets, 0,
                                        *tables, **kw)
    assert td.torcells_span.launches == s0 + 1
    state, tables = td.from_jax_state(st, inst["tables"], dev)
    want = td.torcells_step_window_flush_reference(
        *state, inj, inj_t, targets, 0, *tables, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[8]) > 0


def _run_device_tor(device, **extra):
    """The small device-client tor config of test_torch_device_plane.py
    through the port (no JAX here: the card's machine has none)."""
    from shadow_tpu_torch.core import configuration
    from shadow_tpu_torch.core.checkpoint import state_digest
    from shadow_tpu_torch.core.controller import Controller
    from shadow_tpu_torch.core.options import Options
    from shadow_tpu_torch.tools.workloads import tor_network
    cfg = configuration.parse_xml(tor_network(
        8, n_clients=5, n_servers=2, stoptime=60, stream_spec="512:20200",
        device_data=True))
    ctl = Controller(Options(scheduler_policy="tpu", device=device, seed=3,
                             workers=0, stop_time_sec=60,
                             log_level="warning", **extra), cfg)
    assert ctl.run() == 0
    e = ctl.engine
    st = e.device_plane.stats()
    return {"digest": state_digest(e), "events": e.events_executed,
            "rounds": e.rounds_executed, "forwards": st["forwards"],
            "completed": st["completed"], "dispatches": st["dispatches"],
            "mode": st["mode"], "recoveries": st["recoveries"],
            "mesh": {k: v for k, v in e.metrics.scrape().items()
                     if k.startswith("mesh.")}}


def test_device_clients_on_card_equal_cpu_run(dev):
    from shadow_tpu_torch.ops import torcells_device as td
    s0 = td.torcells_span.launches
    card = _run_device_tor("cuda")
    launched = td.torcells_span.launches - s0
    cpu = _run_device_tor("cpu")
    for key in ("digest", "events", "rounds", "forwards", "completed",
                "dispatches"):
        assert card[key] == cpu[key], key
    assert launched == card["dispatches"] > 0
    assert card["mode"] == "device" and card["recoveries"] == 0


def test_a_failed_launch_ends_the_run(dev, monkeypatch):
    """No fallback on the card: a launch that CUDA refuses raises out of
    the run; the plane is not demoted to the numpy twin."""
    from shadow_tpu_torch.ops import torcells_device as td

    def refused(*_args):
        return 2   # cudaErrorMemoryAllocation

    real = td._bound

    def bound(name, symbol, argtypes):
        fn = real(name, symbol, argtypes)
        return refused if name == "torcells_span" else fn
    monkeypatch.setattr(td, "_bound", bound)
    with pytest.raises(RuntimeError, match="torcells_span kernel launch "
                       "failed: CUDA error 2"):
        _run_device_tor("cuda")


# ---------------------------------------------------------------------------
# the model workloads' kernels (phold, saturate, torcells_run, admit_sorted)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_hosts,n_msgs,horizon", [(32, 64, 2 * 10 ** 9),
                                                    (64, 20000, 10 ** 9),
                                                    (1024, 65536, 10 ** 9)])
def test_phold_kernel_bit_exact_vs_plain_version(dev, n_hosts, n_msgs,
                                                 horizon):
    """In shared memory (64 messages) and in device memory (20,000, and
    65,536 at the bench's 1,024 hosts: two passes of the ripe test)."""
    from shadow_tpu_torch.ops import phold_device as pd
    p = pd.DevicePhold(n_hosts, n_msgs, seed=n_hosts, device="cuda")
    args = (p.latency, torch.as_tensor(p.msg_host, device=dev),
            torch.as_tensor(p.msg_time, device=dev), (p.key_lo, p.key_hi),
            horizon)
    before = pd.phold_run.launches
    got = pd.phold_run(*args, with_windows=True)
    assert pd.phold_run.launches == before + 1
    want = pd.phold_run_torch(*args, with_windows=True)
    for a, b in zip(got, want):
        assert a.device == dev and a.dtype == b.dtype
        assert torch.equal(a, b)
    nh, nt, nhops = p.run_numpy(horizon)
    np.testing.assert_array_equal(got[0].cpu().numpy(), nh)
    np.testing.assert_array_equal(got[1].cpu().numpy(), nt)
    assert int(got[2]) == nhops


def test_saturate_kernel_bit_exact_vs_plain_version(dev):
    from shadow_tpu_torch.ops import saturate_device as sd
    rng = np.random.default_rng(11)
    h = 100
    sat = sd.DeviceSaturate(rng.integers(200, 2000, size=h), device="cuda")
    first = rng.integers(0, 50, size=h).astype(np.int64)
    n = rng.integers(100, 3000, size=h).astype(np.int64)
    args = (torch.as_tensor(first, device=dev), torch.as_tensor(n, device=dev),
            sat.size, sat._refill, sat._capacity, sat.qcap_pkts, 3000)
    before = sd.saturate_run.launches
    got = sd.saturate_run(*args)
    assert sd.saturate_run.launches == before + 1
    want = sd.saturate_run_torch(*args)
    for a, b, c in zip(got, want, sat.run_numpy(first, n, 3000)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.cpu().numpy(), c)


def test_torcells_run_kernel_bit_exact_vs_plain_version(dev):
    from shadow_tpu_torch.ops import torcells_device as td
    tc = td.DeviceTorCells(n_relays=20, n_circuits=60, seed=3,
                           relay_bw_kibps=512, device="cuda")
    q0 = torch.as_tensor(tc._args(40)[0], device=dev)
    before = td.torcells_run.launches
    got = td.torcells_run(q0, *tc.tensors, tc.ring_len, 40_000,
                          tables=tc.tables)
    assert td.torcells_run.launches == before + 1
    want = td.torcells_run_torch(q0, *tc.tensors, tc.ring_len, 40_000)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    d, t, f = tc.run_numpy(40, 40_000)
    np.testing.assert_array_equal(got[0].cpu().numpy(), d)
    assert (int(got[1]), int(got[2])) == (t, f)


@pytest.mark.parametrize("opts,form", [
    (None, "grid"), (dict(g=1), "grid"), (dict(g=8, max_threads=32), "grid"),
    (dict(g=16, max_threads=64), "grid"),
    (dict(g=8, smem_max=0, max_threads=64), "global")])
@pytest.mark.parametrize("below_zero", [False, True])
def test_torcells_run_kernel_bit_exact_in_each_form(dev, opts, form,
                                                     below_zero):
    """The long-node table (~1,000 flows a node) by the size rule, in one
    block, in chunks of 32 and 64 flows, and in the global form."""
    from shadow_tpu_torch.ops import torcells_device as td
    tc = td.DeviceTorCells(n_relays=4, n_circuits=800, seed=41,
                           device="cuda")
    plan = None if opts is None else td._plan_over(
        tc.tables.node_off_host, window=tc.tables.window, **opts)
    q0 = torch.as_tensor(tc._args(2)[0], device=dev)
    if below_zero:                        # the int64 path
        q0[::9] -= 1
    for max_ticks in (200, 40_000):       # a cut, then to completion
        delivered, scalars, ran = td._torcells_run_launch(
            q0, *tc.tensors, tc.ring_len, max_ticks, tables=tc.tables,
            plan=plan)
        assert ran.form == form and (plan is None or ran is plan)
        assert int(scalars[td.RUN_PATH_WORD]) == (not below_zero)
        want = td.torcells_run_torch(q0, *tc.tensors, tc.ring_len,
                                     max_ticks)
        for a, b in zip((delivered, scalars[0], scalars[1]), want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("window", [1, 2])
def test_torcells_run_ends_on_an_odd_tick_in_either_window(dev, window):
    from shadow_tpu_torch.ops import torcells_device as td
    tc = td.DeviceTorCells(n_relays=20, n_circuits=60, seed=3,
                           relay_bw_kibps=512, device="cuda")
    assert tc.tables.window == 2
    plan = td._plan_over(tc.tables.node_off_host, 13, window)
    assert plan.per_sync == window
    q0 = torch.as_tensor(tc._args(41)[0], device=dev)   # 795 ticks
    delivered, scalars, _plan = td._torcells_run_launch(
        q0, *tc.tensors, tc.ring_len, 40_000, tables=tc.tables, plan=plan)
    want = td.torcells_run_torch(q0, *tc.tensors, tc.ring_len, 40_000)
    assert int(scalars[0]) == 795
    for a, b in zip((delivered, scalars[0], scalars[1]), want):
        assert torch.equal(a, b)


def test_a_refused_torcells_run_launch_raises(dev):
    from shadow_tpu_torch.ops import torcells_device as td
    tc = td.DeviceTorCells(n_relays=20, n_circuits=60, seed=3,
                           relay_bw_kibps=512, device="cuda")
    q0 = torch.as_tensor(tc._args(40)[0], device=dev)
    # 1,000 blocks of 1,024 threads: more than any card holds at once, so
    # the cooperative launch is refused
    too_big = td._plan_over(tc.tables.node_off_host, 1000, 1)._replace(
        threads=1024)
    with pytest.raises(RuntimeError, match="torcells_run kernel launch"):
        td._torcells_run_launch(q0, *tc.tensors, tc.ring_len, 100,
                                tables=tc.tables, plan=too_big)


def test_torcells_step_window_kernel_bit_exact_vs_plain_version(dev):
    """The windowed step on the card is one torcells_span launch with the
    single boundary t0 + n_ticks: 7 + 93 ticks, an idle fold, 0 ticks."""
    from shadow_tpu_torch.ops import torcells_device as td
    tc = td.DeviceTorCells(n_relays=6, n_circuits=20, seed=5,
                           relay_bw_kibps=512, max_latency_ms=20,
                           device="cuda")
    f, h, lr = tc.n_flows, len(tc.refill), tc.ring_len
    q0 = torch.as_tensor(tc._args(25)[0], device=dev)
    zero = torch.zeros_like(q0)
    state = [0, zero.clone(), torch.zeros((lr, f), dtype=torch.int32,
                                          device=dev),
             tc.tensors[5].clone(), zero.clone(), zero.clone(),
             torch.full((f,), -1, dtype=torch.int64, device=dev),
             torch.zeros(h, dtype=torch.int64, device=dev)]
    for i, (n, idle) in enumerate(((7, 0), (93, 0), (0, 50), (40, 0))):
        inj = q0 if i == 0 else zero
        want = td.torcells_step_window_torch(state[0], *state[1:], inj, inj,
                                             n, idle, *tc.tensors, lr)
        before = td.torcells_span.launches
        got = td.torcells_step_window(state[0], *[a.clone() for a in
                                                  state[1:]],
                                      inj, inj, n, idle, *tc.tensors, lr,
                                      tables=tc.tables)
        assert td.torcells_span.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        state = [int(got[0])] + list(got[1:8])


@pytest.mark.parametrize("n_hosts,n,invalid", [(8, 256, 0.0),
                                               (2050, 8192, 0.0),
                                               (64, 4096, 0.4)])
def test_admit_sorted_kernel_bit_exact_vs_plain_version(dev, n_hosts, n,
                                                        invalid):
    from shadow_tpu_torch.ops import bandwidth as bw
    rng = np.random.default_rng(n)
    dst = np.sort(rng.integers(0, n_hosts, size=n)).astype(np.int32)
    sizes = rng.integers(60, 1501, size=n).astype(np.int64)
    arrive = rng.integers(10 ** 7, 3 * 10 ** 7, size=n).astype(np.int64)
    valid = rng.random(n) >= invalid
    refill, cap = bw.bucket_params(rng.integers(80, 2000, size=n_hosts))
    tok0 = rng.integers(0, cap + 1).astype(np.int64)
    args = tuple(torch.as_tensor(a, device=dev) for a in
                 (dst, sizes, arrive, valid, tok0, refill, cap))
    before = bw.admit_sorted.launches
    got = bw.admit_sorted(*args)
    assert bw.admit_sorted.launches == before + 1
    assert torch.equal(got, bw.admit_sorted_torch(*args))
    assert not got[~args[3]].any()


@pytest.mark.parametrize("case", chip_smoke.saturate_edge_cases(),
                         ids=lambda c: c[0])
def test_saturate_kernel_bit_exact_on_edge_cases(dev, case):
    """chip_smoke.py's saturate_edge_cases, one launch each: the "edges"
    case mixes hosts on the kernel's 32-bit and int64 paths in one warp."""
    from shadow_tpu_torch.ops import saturate_device as sd
    name, first, npk, size, ref, cap, qcap, ticks = case
    narrow = chip_smoke.saturate_narrow(size, ref, cap, qcap, ticks)
    if name == "edges":
        assert narrow[:32].any() and not narrow[:32].all()
    args = (torch.as_tensor(first, device=dev),
            torch.as_tensor(npk, device=dev), size,
            torch.as_tensor(ref, device=dev),
            torch.as_tensor(cap, device=dev), qcap, ticks)
    before = sd.saturate_run.launches
    got = sd.saturate_run(*args)
    assert sd.saturate_run.launches == before + 1
    for a, b in zip(got, sd.saturate_run_torch(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [*chip_smoke.admit_edge_cases(),
                                  *chip_smoke.admit_carry_cases()],
                         ids=lambda c: c[0])
def test_admit_sorted_kernel_bit_exact_on_edge_cases(dev, case):
    """chip_smoke.py's admit_edge_cases and admit_carry_cases, one launch
    each: runs across the kernel's tiles with invalid lanes at tile edges,
    a whole tile invalid, packets and arrivals past the 32-bit path's
    bounds, invalid lanes of other dsts inside runs (on the tiled and the
    lane kernel), each equal to the plain version, which the CPU tests
    hold to JAX."""
    from shadow_tpu_torch.ops import bandwidth as bw
    name, arrays = case
    args = tuple(torch.as_tensor(a, device=dev) for a in arrays)
    before = bw.admit_sorted.launches
    got = bw.admit_sorted(*args)
    assert bw.admit_sorted.launches == before + 1
    assert torch.equal(got, bw.admit_sorted_torch(*args))
    assert not got[~args[3]].any()


def test_model_wrappers_reject_what_their_kernels_do_not_take(dev):
    from shadow_tpu_torch.ops import bandwidth as bw
    from shadow_tpu_torch.ops import phold_device as pd
    from shadow_tpu_torch.ops import saturate_device as sd
    i64 = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="dst_rows"):
        bw.admit_sorted(i64, i64, i64, i64 > 0, i64, i64, i64)
    with pytest.raises(ValueError, match="msg_host"):
        pd.phold_run(torch.zeros((4, 4), dtype=torch.int64, device=dev),
                     i64, i64, (1, 2), 10)
    with pytest.raises(ValueError, match="size"):
        sd.saturate_run(i64, i64, 0, i64, i64, 4, 10)


# ---------------------------------------------------------------------------
# the mesh: mesh_span + the mesh flush, the sharded hop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev,mode,masked", [
    (8, "fused", False), (8, "ppermute", False), (8, "ppermute", True),
    (3, "fused", False), (3, "none", False), (2, "ppermute", False)])
def test_mesh_kernels_bit_exact_vs_plain_version(dev, n_dev, mode, masked):
    _mesh_windows_vs_plain(dev, n_dev, mode, masked)


@pytest.mark.parametrize("n_dev,mode,caps", [
    (8, "fused", (40, 300)), (3, "ppermute", (5000, 9000))])
def test_capped_mesh_flush_kernel_bit_exact(dev, n_dev, mode, caps):
    """The mesh entry of pack_flush.cu with caps, below the windows'
    counts (overflow) and above them, against the plain mesh version."""
    _mesh_windows_vs_plain(dev, n_dev, mode, False, caps)


def _mesh_windows_vs_plain(dev, n_dev, mode, masked, caps=(None, None)):
    from shadow_tpu_torch.ops.torcells_device import DeviceTorCells
    from shadow_tpu_torch.parallel.mesh import device_mesh
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    from shadow_tpu_torch.parallel.mesh.partition import (build_mesh_layout,
                                                          pad_state)
    inst = DeviceTorCells(n_relays=60, n_circuits=2000, seed=7,
                          relay_bw_kibps=512, max_latency_ms=20,
                          device="cpu")
    fl = inst.flows
    h = len(inst.refill)
    last_flow = np.flatnonzero(fl["flow_succ"] < 0)
    lay = build_mesh_layout(fl["flow_node"], fl["flow_lat"], fl["flow_succ"],
                            fl["seg_start"], inst.refill, inst.capacity,
                            n_dev)
    legs = lay["exchange"].legs
    lm = tuple(k % 2 == 0 for k in range(legs)) if masked else None
    fp, hp = len(lay["src"]), len(lay["refill"])
    statics = tuple(torch.as_tensor(lay[k], device=dev) for k in (
        "flow_node_local", "succ_global", "seg_start_local", "refill",
        "capacity", "arr_lat", "shard_base"))
    q0 = pad_state(lay, np.where(fl["flow_stage"] == 0, 30, 0))
    t0 = pad_state(lay, np.where(fl["flow_succ"] < 0, 30, 0))
    zp = np.zeros(fp, np.int64)

    def windows(step):
        st = [torch.zeros(fp, dtype=torch.int64, device=dev),
              torch.zeros((inst.ring_len, fp), dtype=torch.int32,
                          device=dev),
              torch.as_tensor(lay["capacity"], device=dev),
              torch.zeros(fp, dtype=torch.int64, device=dev),
              torch.zeros(fp, dtype=torch.int64, device=dev),
              torch.full((fp,), -1, dtype=torch.int64, device=dev),
              torch.zeros(hp, dtype=torch.int64, device=dev)]
        out, t = [], 0
        for inj, inj_t, tv, idle in ((q0, t0, [40], 0),
                                     (zp, zp, [140, 240, 540], 0),
                                     (q0, t0, [560, 600], 5)):
            o = step(t, *st, torch.as_tensor(inj, device=dev),
                     torch.as_tensor(inj_t, device=dev), np.array(tv), idle,
                     *statics)
            out.append([x.clone() for x in o])
            t, st = int(o[0]), list(o[1:8])
        return out

    step = ex.make_mesh_span_flush(
        device_mesh(n_dev, device=dev), "flows", inst.ring_len, lay,
        lay["inv"][last_flow], lay["node_src"], h, mode=mode, leg_mask=lm,
        cap_chains=caps[0], cap_nodes=caps[1])
    s0, p0 = ex.mesh_span.launches, ex.mesh_pack_flush.launches
    got = windows(step)
    assert (ex.mesh_span.launches - s0, ex.mesh_pack_flush.launches - p0) \
        == (3, 3)

    def plain(*a):
        return ex.mesh_span_flush_torch(
            *a, ring_len=inst.ring_len, schedule=lay["exchange"],
            last_flow_pad=torch.as_tensor(lay["inv"][last_flow], device=dev),
            node_src=torch.as_tensor(lay["node_src"], device=dev),
            n_nodes=h, mode=mode, leg_mask=lm, cap_chains=caps[0],
            cap_nodes=caps[1])
    want = windows(plain)
    torch.cuda.synchronize()
    for w, (g, p) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, p)):
            assert torch.equal(a, b), (w, i)


@pytest.mark.parametrize("mode", ("fused", "ppermute", "none"))
def test_mesh_kernels_on_nodes_longer_than_a_chunk(dev, mode):
    """Two shards of a table whose relays pace ~600 flows each (longer
    than a tile and the kernel's 512-flow chunk): the mesh kernels equal
    the plain mesh version over three windows (injections, a halt, an
    idle fold)."""
    from shadow_tpu_torch.ops.torcells_device import (CHUNK_FLOWS,
                                                      DeviceTorCells)
    from shadow_tpu_torch.parallel.mesh import device_mesh
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    from shadow_tpu_torch.parallel.mesh.partition import (build_mesh_layout,
                                                          pad_state)
    inst = DeviceTorCells(n_relays=4, n_circuits=800, seed=41, device="cpu")
    fl = inst.flows
    h = len(inst.refill)
    last_flow = np.flatnonzero(fl["flow_succ"] < 0)
    lay = build_mesh_layout(fl["flow_node"], fl["flow_lat"], fl["flow_succ"],
                            fl["seg_start"], inst.refill, inst.capacity, 2)
    tables = ex.MeshTables(lay, inst.ring_len, lay["inv"][last_flow],
                           lay["node_src"], h, mode)
    assert np.diff(tables.node_off.numpy()).max() > CHUNK_FLOWS
    fp, hp = len(lay["src"]), len(lay["refill"])
    statics = tuple(torch.as_tensor(lay[k], device=dev) for k in (
        "flow_node_local", "succ_global", "seg_start_local", "refill",
        "capacity", "arr_lat", "shard_base"))
    q0 = pad_state(lay, np.where(fl["flow_stage"] == 0, 40, 0))
    t0 = pad_state(lay, np.where(fl["flow_succ"] < 0, 40, 0))
    zp = np.zeros(fp, np.int64)

    def windows(step):
        st = [torch.zeros(fp, dtype=torch.int64, device=dev),
              torch.zeros((inst.ring_len, fp), dtype=torch.int32,
                          device=dev),
              torch.as_tensor(lay["capacity"], device=dev),
              torch.zeros(fp, dtype=torch.int64, device=dev),
              torch.zeros(fp, dtype=torch.int64, device=dev),
              torch.full((fp,), -1, dtype=torch.int64, device=dev),
              torch.zeros(hp, dtype=torch.int64, device=dev)]
        out, t = [], 0
        for inj, inj_t, tv, idle in ((q0, t0, [200], 0),
                                     (zp, zp, [400, 800, 4000], 0),
                                     (q0, t0, [420, 600], 7)):
            o = step(t, *st, torch.as_tensor(inj, device=dev),
                     torch.as_tensor(inj_t, device=dev), np.array(tv), idle,
                     *statics)
            out.append([x.clone() for x in o])
            t, st = int(o[0]), list(o[1:8])
        return out

    step = ex.make_mesh_span_flush(
        device_mesh(2, device=dev), "flows", inst.ring_len, lay,
        lay["inv"][last_flow], lay["node_src"], h, mode=mode)
    s0 = ex.mesh_span.launches
    got = windows(step)
    assert ex.mesh_span.launches - s0 == 3

    def plain(*a):
        return ex.mesh_span_flush_torch(
            *a, ring_len=inst.ring_len, schedule=lay["exchange"],
            last_flow_pad=torch.as_tensor(lay["inv"][last_flow], device=dev),
            node_src=torch.as_tensor(lay["node_src"], device=dev),
            n_nodes=h, mode=mode)
    want = windows(plain)
    torch.cuda.synchronize()
    for w, (g, p) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, p)):
            assert torch.equal(a, b), (w, i)


@pytest.mark.parametrize("n_dev,shard_matrix", [(8, False), (8, True),
                                                (3, False), (3, True)])
def test_sharded_hop_kernels_bit_exact(dev, n_dev, shard_matrix):
    rng = np.random.default_rng(n_dev)
    lat = rng.integers(1_000_000, 90_000_000, size=(A, A), dtype=np.int64)
    rel = rng.random((A, A)).astype(np.float32)
    rel[rng.random((A, A)) < 0.3] = 1.0
    card = rs.ShardedPacketHopKernel.from_arrays(
        lat, rel, DROP_KEY, BOOTSTRAP_END, dev, n_devices=n_dev,
        shard_matrix=shard_matrix)
    plain = rs.ShardedPacketHopKernel.from_arrays(
        lat, rel, DROP_KEY, BOOTSTRAP_END, "cpu", n_devices=n_dev,
        shard_matrix=shard_matrix)
    one = rs.PacketHopKernel.from_arrays(lat, rel, DROP_KEY, BOOTSTRAP_END,
                                         dev)
    for n in (256, 4096, 65536):
        cols = (rng.integers(0, A, n), rng.integers(0, A, n),
                rng.integers(0, 2 ** 64, size=n, dtype=np.uint64),
                rng.integers(0, 2 * BOOTSTRAP_END, n))
        s0 = rs.packet_hop_sharded.launches
        a = card.step(*cols, BOOTSTRAP_END + 40_000_000)
        launched = rs.packet_hop_sharded.launches - s0
        assert launched == 1
        for other in (plain, one):
            b = other.step(*cols, BOOTSTRAP_END + 40_000_000)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_device_clients_on_the_mesh_on_card_equal_cpu_run(dev):
    from shadow_tpu_torch.ops import torcells_device as td
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    counts = (ex.mesh_span.launches, ex.mesh_pack_flush.launches,
              td.torcells_span.launches, rs.packet_hop_sharded.launches,
              rs.packet_hop_packed.launches + rs.packet_hop_mapped.launches)
    card = _run_device_tor("cuda", tpu_devices=8)
    launched = [a - b for a, b in zip(
        (ex.mesh_span.launches, ex.mesh_pack_flush.launches,
         td.torcells_span.launches, rs.packet_hop_sharded.launches,
         rs.packet_hop_packed.launches + rs.packet_hop_mapped.launches),
        counts)]
    cpu = _run_device_tor("cpu", tpu_devices=8)
    for key in ("digest", "events", "rounds", "forwards", "completed",
                "dispatches", "mesh"):
        assert card[key] == cpu[key], key
    # one mesh span and one mesh flush launch a dispatch, no single-table
    # span, and the hop through the batch-sharded kernel only
    assert launched[0] == launched[1] == card["dispatches"] > 0
    assert launched[2] == 0 and launched[4] == 0 and launched[3] > 0
    assert card["mesh"]["mesh.host_bounces"] == 0
    assert card["mesh"]["mesh.cross_shard_cells"] > 0


def test_a_failed_mesh_launch_ends_the_run(dev, monkeypatch):
    from shadow_tpu_torch.parallel.mesh import exchange as ex
    real = ex._bound

    def bound(name, symbol, argtypes):
        fn = real(name, symbol, argtypes)
        return (lambda *_a: 2) if name == "mesh_span" else fn
    monkeypatch.setattr(ex, "_bound", bound)
    with pytest.raises(RuntimeError, match="mesh_span kernel launch failed"):
        _run_device_tor("cuda", tpu_devices=8)
