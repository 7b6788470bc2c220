"""The device-resident cell model in the port (``torcells_run``, the
windowed ``torcells_step_window`` and ``DeviceTorCells``), on the CPU,
against the JAX package.

The port's ``torcells_run`` and ``torcells_step_window`` (on CPU tensors:
their plain torch versions) must equal, bit for bit, the JAX package's
functions and numpy twins: run to completion on the JAX test's instance
(``DeviceTorCells(20, 60)`` with 40 cells a circuit), one window of the
run's length, windows split 7 + 93 + 500, an idle fold, and n_ticks = 0.
The windowed step keeps the span kernel's int32 ring and refuses any other
with a TypeError.  Tolerance: none (int64, exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shadow_tpu.ops.torcells_device as jtd
import shadow_tpu_torch.ops.torcells_device as ttd
from shadow_tpu_torch.ops.bandwidth import bucket_params
from shadow_tpu_torch.ops.torcells_device import CELL_WIRE_BYTES

NAMES = ("t", "queued", "ring", "tokens", "delivered", "target", "done_tick",
         "node_sent", "forwards")


def test_run_matches_jax_and_numpy_twin():
    port = ttd.DeviceTorCells(n_relays=20, n_circuits=60, seed=3,
                              relay_bw_kibps=512, device="cpu")
    ref = jtd.DeviceTorCells(n_relays=20, n_circuits=60, seed=3,
                             relay_bw_kibps=512)
    d, t, f = port.run_device(40, 40_000)
    jd, jt, jf = ref.run_device(40, 40_000)
    nd, nt, nf = port.run_numpy(40, 40_000)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(d, nd)
    assert t == jt == nt and f == jf == nf


def test_numpy_twins_equal_the_jax_package():
    ref = jtd.DeviceTorCells(n_relays=6, n_circuits=20, seed=5,
                             relay_bw_kibps=512, max_latency_ms=20)
    fl = ref.flows
    q0 = np.where(fl["flow_stage"] == 0, 30, 0).astype(np.int64)
    args = (q0, fl["flow_node"], fl["flow_lat"], fl["flow_succ"],
            fl["seg_start"], ref.refill, ref.capacity, ref.ring_len)
    a = ttd.torcells_run_numpy(*args, 5000)
    b = jtd.torcells_run_numpy(*args, 5000)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


def test_run_stops_at_max_ticks():
    port = ttd.DeviceTorCells(n_relays=20, n_circuits=60, seed=3,
                              relay_bw_kibps=512, device="cpu")
    ref = jtd.DeviceTorCells(n_relays=20, n_circuits=60, seed=3,
                             relay_bw_kibps=512)
    d, t, f = port.run_device(40, 150)
    jd, jt, jf = ref.run_device(40, 150)
    assert t == jt == 150 and f == jf
    np.testing.assert_array_equal(d, jd)
    # nothing queued: no tick at all
    assert port.run_device(0, 100)[1:] == (0, 0)


def test_cell_conservation_and_hops():
    c, per = 60, 40
    m = ttd.DeviceTorCells(n_relays=20, n_circuits=c, seed=3,
                           relay_bw_kibps=512, device="cpu")
    delivered, ticks, forwards = m.run_device(per, 40_000)
    st = m.flows["flow_stage"]
    circ = m.flows["flow_circ"]
    assert delivered[st == 4].sum() == c * per
    per_circ = np.zeros(c, dtype=np.int64)
    np.add.at(per_circ, circ[st == 4], delivered[st == 4])
    assert (per_circ == per).all()
    assert forwards == c * per * 5
    assert ticks < 40_000


def test_contention_slows_shared_relays():
    fat = ttd.DeviceTorCells(n_relays=8, n_circuits=40, seed=5,
                             relay_bw_kibps=1 << 20, device="cpu")
    thin = ttd.DeviceTorCells(n_relays=8, n_circuits=40, seed=5,
                              relay_bw_kibps=256, device="cpu")
    _d1, t_fat, _ = fat.run_device(50, 200_000)
    _d2, t_thin, _ = thin.run_device(50, 200_000)
    assert t_thin > t_fat * 2
    total_relay_bytes = 40 * 50 * 3 * CELL_WIRE_BYTES
    refill, _cap = bucket_params(np.full(8, 256))
    assert t_thin >= (total_relay_bytes // int(refill.sum() + 1)) // 2


@pytest.mark.parametrize("kw", [
    dict(n_relays=20, n_circuits=60, seed=3, relay_bw_kibps=512),
    dict(n_relays=200, n_circuits=2000, seed=23, relay_bw_kibps=4096),
    dict(n_relays=6, n_circuits=20, seed=5, relay_bw_kibps=512,
         max_latency_ms=20),
])
def test_classes_build_equal_arrays(kw):
    port = ttd.DeviceTorCells(**kw, device="cpu")
    ref = jtd.DeviceTorCells(**kw)
    np.testing.assert_array_equal(port.route, ref.route)
    np.testing.assert_array_equal(port.refill, ref.refill)
    np.testing.assert_array_equal(port.capacity, ref.capacity)
    assert (port.ring_len, port.n_flows) == (ref.ring_len, ref.n_flows)
    assert port.flows.keys() == ref.flows.keys()
    for key in ref.flows:
        np.testing.assert_array_equal(port.flows[key], ref.flows[key],
                                      err_msg=key)
    for a, key in zip(port.tensors, ("flow_node", "flow_lat", "flow_succ",
                                     "seg_start")):
        np.testing.assert_array_equal(a.numpy(), ref.flows[key])


# ---------------------------------------------------------------------------
# the windowed step (the JAX package's tests/test_device_plane.py:48-148)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    """The JAX package's toy instance: 20 circuits over 6 relays."""
    kw = dict(n_relays=6, n_circuits=20, seed=5, relay_bw_kibps=512,
              max_latency_ms=20)
    return ttd.DeviceTorCells(**kw, device="cpu"), jtd.DeviceTorCells(**kw)


def _np_state(inst):
    f, h = inst.n_flows, len(inst.refill)
    return [np.int64(0), np.zeros(f, np.int64),
            np.zeros((inst.ring_len, f), np.int64),
            inst.capacity.copy().astype(np.int64), np.zeros(f, np.int64),
            np.zeros(f, np.int64), np.full(f, -1, np.int64),
            np.zeros(h, np.int64)]


def _port_state(st):
    out = [int(st[0])]
    for i, a in enumerate(st[1:]):
        out.append(torch.from_numpy(np.array(
            a, dtype=np.int32 if i == 1 else np.int64)))
    return out


def _flow_args(inst):
    fl = inst.flows
    return (fl["flow_node"], fl["flow_lat"], fl["flow_succ"],
            fl["seg_start"], inst.refill, inst.capacity)


def _jax_window(inst, st, inj, inj_t, n, idle):
    out = jtd.torcells_step_window(
        *(jnp.asarray(np.array(a)) for a in st), jnp.asarray(inj),
        jnp.asarray(inj_t), np.int64(n), np.int64(idle),
        *(jnp.asarray(a) for a in _flow_args(inst)), ring_len=inst.ring_len)
    return [np.asarray(o) for o in out]


def _port_window(port, st, inj, inj_t, n, idle):
    out = ttd.torcells_step_window(
        st[0], *st[1:], torch.from_numpy(inj), torch.from_numpy(inj_t), n,
        idle, *port.tensors, port.ring_len)
    return [int(out[0])] + list(out[1:])


def _assert_same(port_out, ref_out, what):
    assert port_out[2].dtype == torch.int32
    for name, a, b in zip(NAMES, port_out, ref_out):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{what}: {name}")


def test_one_window_matches_run_to_completion(toy):
    port, ref = toy
    q0 = np.where(port.flows["flow_stage"] == 0, 40, 0).astype(np.int64)
    d, ticks, fwd = port.run_device(40, 5000)
    out = _port_window(port, _port_state(_np_state(ref)), q0, q0, ticks, 0)
    np.testing.assert_array_equal(out[4].numpy(), d)
    assert int(out[8]) == fwd and out[0] == ticks
    _assert_same(out, _jax_window(ref, _np_state(ref), q0, q0, ticks, 0),
                 "one window vs JAX")


def test_split_windows_and_idle_fold_match_jax_and_twin(toy):
    port, ref = toy
    f = port.n_flows
    last = port.flows["flow_stage"] == 4
    q0 = np.where(port.flows["flow_stage"] == 0, 25, 0).astype(np.int64)
    tgt = np.where(last, 25, 0).astype(np.int64)
    zeros = np.zeros(f, np.int64)
    big = jtd.torcells_step_window_numpy(*_np_state(ref), q0, tgt, 600, 0,
                                         *_flow_args(ref), ref.ring_len)
    pst, jst = _port_state(_np_state(ref)), _np_state(ref)
    for i, n in enumerate((7, 93, 500)):
        inj, it = (q0, tgt) if i == 0 else (zeros, zeros)
        pout = _port_window(port, pst, inj, it, n, 0)
        jout = _jax_window(ref, jst, inj, it, n, 0)
        nout = ttd.torcells_step_window_numpy(
            *[np.array(a) for a in jst], inj, it, n, 0, *_flow_args(ref),
            ref.ring_len)
        _assert_same(pout, jout, f"window {n} vs JAX")
        _assert_same(pout, nout, f"window {n} vs the numpy twin")
        pst, jst = pout[:8], jout[:8]
    for i in (1, 3, 4, 5, 6, 7):
        np.testing.assert_array_equal(np.asarray(pst[i]), big[i])
    assert (np.asarray(pst[6])[last] >= 0).all()   # every chain finished
    # idle fold: 100 empty ticks == banking them as idle ticks (tokens and
    # delivered), and the fold itself (n_ticks 0) equals JAX's
    run_a = _port_window(port, [pst[0]] + [a.clone() for a in pst[1:]],
                         zeros, zeros, 100, 0)
    run_b = _port_window(port, [pst[0]] + [a.clone() for a in pst[1:]],
                         zeros, zeros, 0, 100)
    assert torch.equal(run_a[3], run_b[3]) and torch.equal(run_a[4],
                                                           run_b[4])
    _assert_same(run_b, _jax_window(ref, jst, zeros, zeros, 0, 100),
                 "idle fold vs JAX")
    assert run_b[0] == pst[0] and not run_b[2].any()


def test_zero_ticks_with_an_injection(toy):
    port, ref = toy
    rng = np.random.default_rng(4)
    inj = rng.integers(0, 9, size=port.n_flows).astype(np.int64)
    st = _np_state(ref)
    st[2] = rng.integers(0, 5, size=st[2].shape).astype(np.int64)
    st[3] = (st[3] // 2).astype(np.int64)
    pout = _port_window(port, _port_state(st), inj, inj, 0, 0)
    _assert_same(pout, _jax_window(ref, st, inj, inj, 0, 0), "n_ticks 0")
    assert pout[0] == 0 and int(pout[8]) == 0


def test_windowed_step_refuses_another_ring_dtype(toy):
    port, ref = toy
    st = _port_state(_np_state(ref))
    zeros = torch.zeros(port.n_flows, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        ttd.torcells_step_window(st[0], st[1], st[2].to(torch.int64),
                                 *st[3:], zeros, zeros, 5, 0, *port.tensors,
                                 port.ring_len)
    big = list(port.tensors)
    big[5] = torch.full_like(big[5], 2 ** 45)
    with pytest.raises(ValueError, match="int32 ring"):
        ttd.torcells_step_window(*st, zeros, zeros, 5, 0, *big,
                                 port.ring_len)
