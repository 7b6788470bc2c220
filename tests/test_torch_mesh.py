"""The port's mesh traffic plane step (shadow_tpu_torch/parallel/mesh/) on
the CPU, against the JAX package's on its 8 virtual XLA devices.

1. The statics: the chain partition, the padded layout, the BvN exchange
   schedule and ``leg_of_edges`` equal the JAX package's on
   ``DeviceTorCells(6, 20, seed 5)``; the copied functions are copies.
2. The step: the plain mesh version (``make_mesh_span_flush`` on CPU
   tensors) is bit-exact against the JAX package's ``make_mesh_span_flush``
   at D in {8, 3, 2}, in every exchange mode (fused, ppermute, none) and
   with a leg mask, across split windows, packed flush and trailing
   cross-shard slot included; and against the single-table step on the
   unpadded layout (the exactness argument of exchange.py).
3. The kernel's tables: a numpy model of csrc/mesh_span.cu and of the
   mesh entry of csrc/pack_flush.cu, walking the ``MeshTables`` as the
   kernels do (tiles of whole nodes, a thread per flow and two block scans
   a chunk, sends into the ring or this tick's half of the exchange
   buffer, each receive by its own column's flow a tick later, the last
   tick's after the loop), reproduces the plain version bit for bit: a
   mid-span halt, an idle fold, an injection on a boundary.  The kernels
   themselves run in tests/test_torch_cuda.py; tests/test_torch_mesh_tiles.py
   holds the same model, at small chunks, to the JAX package.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.ops.torcells_device import DeviceTorCells as JDeviceTorCells
from shadow_tpu.ops.torcells_device import RING_DTYPE
from shadow_tpu.parallel.mesh import device_mesh as jdevice_mesh
from shadow_tpu.parallel.mesh import exchange as jex
from shadow_tpu.parallel.mesh import partition as jpart
from shadow_tpu_torch.ops.torcells_device import (
    CELL_WIRE_BYTES, DeviceTorCells, flush_len,
    torcells_step_window_flush_reference)
from shadow_tpu_torch.parallel.mesh import device_mesh
from shadow_tpu_torch.parallel.mesh import exchange as tex
from shadow_tpu_torch.parallel.mesh import partition as tpart
from test_torch_torcells_cases import tile_kernel_span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = (8, 3, 2)


@pytest.fixture(scope="module")
def toy():
    """The toy flow table of tests/test_meshplane.py, built by both
    packages (the port's on the CPU)."""
    kw = dict(n_relays=6, n_circuits=20, seed=5, relay_bw_kibps=512,
              max_latency_ms=20)
    j = JDeviceTorCells(**kw)
    t = DeviceTorCells(device="cpu", **kw)
    for k in ("flow_node", "flow_lat", "flow_succ", "seg_start",
              "flow_stage"):
        np.testing.assert_array_equal(np.asarray(t.flows[k]),
                                      np.asarray(j.flows[k]), err_msg=k)
    return j


def _layout(mod, inst, n_dev):
    fl = inst.flows
    return mod.build_mesh_layout(fl["flow_node"], fl["flow_lat"],
                                 fl["flow_succ"], fl["seg_start"],
                                 inst.refill, inst.capacity, n_dev)


# -- 1. statics -------------------------------------------------------------

@pytest.mark.parametrize("n_dev", SHARDS)
def test_partition_layout_schedule_and_legs_equal_jax(toy, n_dev):
    fl = toy.flows
    a = tpart.chain_partition(fl["flow_node"], fl["flow_succ"], n_dev)
    b = jpart.chain_partition(fl["flow_node"], fl["flow_succ"], n_dev)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    np.testing.assert_array_equal(
        tpart.contiguous_partition(fl["flow_node"], n_dev),
        jpart.contiguous_partition(fl["flow_node"], n_dev))
    tl, jl = _layout(tpart, toy, n_dev), _layout(jpart, toy, n_dev)
    assert set(tl) == set(jl)
    for k in tl:
        if k != "exchange":
            np.testing.assert_array_equal(np.asarray(tl[k]),
                                          np.asarray(jl[k]), err_msg=k)
    ts, js = tl["exchange"], jl["exchange"]
    for k in jex.ExchangeSchedule.__slots__:
        tv, jv = getattr(ts, k), getattr(js, k)
        if isinstance(tv, list):
            assert len(tv) == len(jv), k
            for x, y in zip(tv, jv):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv),
                                          err_msg=k)
    np.testing.assert_array_equal(
        tex.leg_of_edges(tl["succ_global"], tl["pad"], ts),
        jex.leg_of_edges(jl["succ_global"], jl["pad"], js))
    for override in ("auto", "fused", "ppermute"):
        assert tex.choose_exchange_mode(ts, None, override) == \
            jex.choose_exchange_mode(js, None, override)
    np.testing.assert_array_equal(
        tex.shard_edge_matrix(tl["succ_global"], tl["pad"], n_dev),
        jex.shard_edge_matrix(jl["succ_global"], jl["pad"], n_dev))


def _sources(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    return text, {n.name: ast.get_source_segment(text, n)
                  for n in ast.parse(text).body
                  if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("name", [
    "ExchangeSchedule", "shard_edge_matrix", "build_exchange",
    "leg_of_edges", "choose_exchange_mode", "mesh_flush_extra"])
def test_exchange_statics_are_copies(name):
    """The schedule and its helpers are copied from the JAX package; only
    the docstrings' history references were dropped."""
    _, port = _sources(os.path.join(
        REPO, "shadow_tpu_torch/parallel/mesh/exchange.py"))
    _, ref = _sources(os.path.join(REPO, "shadow_tpu/parallel/mesh/"
                                   "exchange.py"))

    def code(src):
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                    and ast.get_docstring(node) is not None:
                node.body = node.body[1:]
        return ast.dump(tree)

    assert code(port[name]) == code(ref[name])


def test_device_mesh_puts_every_shard_on_one_device():
    mesh = device_mesh(3, axis_names=("pkt",), device="cpu")
    assert mesh.n_shards == 3 and mesh.device.type == "cpu"
    assert mesh.shard_slice(2, 12) == slice(8, 12)
    with pytest.raises(ValueError):
        mesh.shard_slice(0, 10)
    with pytest.raises(ValueError):
        device_mesh(0, device="cpu")


# -- 2. the step against the JAX package's -----------------------------------

def _inputs(inst):
    fl = inst.flows
    last_flow = np.flatnonzero(fl["flow_succ"] < 0)
    queued0 = np.where(fl["flow_stage"] == 0, 30, 0).astype(np.int64)
    target0 = np.where(fl["flow_succ"] < 0, 30, 0).astype(np.int64)
    return last_flow, queued0, target0


WINDOWS = ((np.array([40]), 0), (np.array([140, 240, 540]), 0))


def _mesh_state(lay, ring_len):
    fp, hp = len(lay["src"]), len(lay["refill"])
    return (np.zeros(fp, np.int64), np.zeros((ring_len, fp), RING_DTYPE),
            lay["capacity"].copy(), np.zeros(fp, np.int64),
            np.zeros(fp, np.int64), np.full(fp, -1, np.int64),
            np.zeros(hp, np.int64))


def _statics(lay):
    return tuple(lay[k] for k in ("flow_node_local", "succ_global",
                                  "seg_start_local", "refill", "capacity",
                                  "arr_lat", "shard_base"))


def _leg_mask(lay, masked):
    legs = lay["exchange"].legs
    return tuple(k % 2 == 0 for k in range(legs)) if masked else None


def _run_port(step, lay, inst, queued0, target0):
    from shadow_tpu.parallel.mesh.partition import pad_state
    fp = len(lay["src"])
    zp = np.zeros(fp, np.int64)
    out = (0,) + tuple(torch.as_tensor(a) for a in
                       _mesh_state(lay, inst.ring_len))
    outs = []
    for (tv, idle), inj in zip(WINDOWS, ((pad_state(lay, queued0),
                                          pad_state(lay, target0)),
                                         (zp, zp))):
        out = step(int(out[0]), *out[1:8], *inj, tv, idle, *_statics(lay))
        outs.append([np.asarray(o) for o in out])
    return outs


# every mode at every D, the leg mask where it changes what is exchanged
# (ppermute), and once each where the JAX package ignores it (fused) and
# where the heuristic picks the mode (None: fused at D = 8, the lone
# ppermute at D = 2, whose schedule has one leg)
STEP_CASES = [(d, m, False) for d in SHARDS
              for m in ("fused", "ppermute", "none")] \
    + [(d, "ppermute", True) for d in SHARDS] \
    + [(8, "fused", True), (8, None, False), (2, None, False)]


@pytest.mark.parametrize("n_dev,mode,masked", STEP_CASES)
def test_mesh_step_equals_jax(toy, n_dev, mode, masked):
    _, queued0, target0 = _inputs(toy)
    last_flow = _inputs(toy)[0]
    h = len(toy.refill)
    lay = _layout(jpart, toy, n_dev)
    lm = _leg_mask(lay, masked)
    jstep = jex.make_mesh_span_flush(
        jdevice_mesh(n_dev, axis_names=("flows",)), "flows", toy.ring_len,
        lay, lay["inv"][last_flow], lay["node_src"], h, mode=mode,
        leg_mask=lm)
    tstep = tex.make_mesh_span_flush(
        device_mesh(n_dev, device="cpu"), "flows", toy.ring_len,
        _layout(tpart, toy, n_dev), lay["inv"][last_flow], lay["node_src"],
        h, mode=mode, leg_mask=lm)
    port = _run_port(tstep, lay, toy, queued0, target0)
    from shadow_tpu.parallel.mesh.partition import pad_state
    fp = len(lay["src"])
    zp = np.zeros(fp, np.int64)
    out = (np.int64(0),) + tuple(jnp.asarray(a) for a in
                                 _mesh_state(lay, toy.ring_len))
    for w, ((tv, idle), inj) in enumerate(zip(
            WINDOWS, ((pad_state(lay, queued0), pad_state(lay, target0)),
                      (zp, zp)))):
        out = jstep(*out[:8], *inj, tv, np.int64(idle), *_statics(lay))
        for i in range(10):
            np.testing.assert_array_equal(port[w][i], np.asarray(out[i]),
                                          err_msg=f"window {w} output {i}")
    if mode == "none":
        assert port[1][9][-1] == 0
    elif not (masked and mode == "ppermute"):
        assert port[1][9][-1] > 0       # the legs carried cells


def test_jax_mesh_state_carries_over(toy):
    """from_jax_state takes the JAX mesh's padded state and layout statics
    as they are (the global layout, ring split by columns): a window run
    by the JAX package continues in the port as it would in JAX."""
    from shadow_tpu.parallel.mesh.partition import pad_state
    from shadow_tpu_torch.ops.torcells_device import from_jax_state
    last_flow, queued0, target0 = _inputs(toy)
    h = len(toy.refill)
    lay = _layout(jpart, toy, 3)
    jstep = jex.make_mesh_span_flush(
        jdevice_mesh(3, axis_names=("flows",)), "flows", toy.ring_len, lay,
        lay["inv"][last_flow], lay["node_src"], h)
    tstep = tex.make_mesh_span_flush(
        device_mesh(3, device="cpu"), "flows", toy.ring_len,
        _layout(tpart, toy, 3), lay["inv"][last_flow], lay["node_src"], h)
    fp = len(lay["src"])
    zp = np.zeros(fp, np.int64)
    out = jstep(np.int64(0), *(jnp.asarray(a) for a in
                               _mesh_state(lay, toy.ring_len)),
                pad_state(lay, queued0), pad_state(lay, target0),
                np.array([40]), np.int64(0), *_statics(lay))
    state, statics = from_jax_state(tuple(np.array(a) for a in out[:8]),
                                    _statics(lay), "cpu")
    assert state[2].dtype == torch.int32 and state[2].shape == (
        toy.ring_len, fp)
    want = jstep(*out[:8], zp, zp, np.array([140, 240, 540]), np.int64(0),
                 *_statics(lay))
    got = tstep(*state, zp, zp, np.array([140, 240, 540]), 0, *statics)
    for i in range(10):
        np.testing.assert_array_equal(np.asarray(got[i]),
                                      np.asarray(want[i]))


@pytest.mark.parametrize("n_dev", SHARDS)
def test_mesh_step_equals_single_table_step(toy, n_dev):
    """The exactness argument: every mode on the padded layout gives the
    single-table step's bits on the unpadded one, read back through
    ``inv`` (the flush is the same buffer plus the trailing slot)."""
    last_flow, queued0, target0 = _inputs(toy)
    fl = toy.flows
    f, h = toy.n_flows, len(toy.refill)
    args = tuple(torch.as_tensor(np.asarray(a)) for a in (
        fl["flow_node"], fl["flow_lat"], fl["flow_succ"], fl["seg_start"],
        toy.refill, toy.capacity, last_flow))
    out = (0, torch.zeros(f, dtype=torch.int64),
           torch.zeros((toy.ring_len, f), dtype=torch.int32),
           args[5].clone(), torch.zeros(f, dtype=torch.int64),
           torch.zeros(f, dtype=torch.int64),
           torch.full((f,), -1, dtype=torch.int64),
           torch.zeros(h, dtype=torch.int64))
    ref = []
    zero = torch.zeros(f, dtype=torch.int64)
    for (tv, idle), inj in zip(WINDOWS, ((torch.as_tensor(queued0),
                                          torch.as_tensor(target0)),
                                         (zero, zero))):
        out = torcells_step_window_flush_reference(
            int(out[0]), *out[1:8], *inj, tv, idle, *args, toy.ring_len)
        ref.append(out)
    lay = _layout(tpart, toy, n_dev)
    inv = lay["inv"]
    for mode in ("fused", "ppermute"):
        step = tex.make_mesh_span_flush(
            device_mesh(n_dev, device="cpu"), "flows", toy.ring_len, lay,
            inv[last_flow], lay["node_src"], h, mode=mode)
        port = _run_port(step, lay, toy, queued0, target0)
        for w in range(2):
            for name, i in (("queued", 1), ("delivered", 4), ("target", 5),
                            ("done", 6)):
                np.testing.assert_array_equal(port[w][i][inv],
                                              ref[w][i].numpy(),
                                              err_msg=f"{mode} {name}")
            np.testing.assert_array_equal(port[w][2][:, inv],
                                          ref[w][2].numpy())
            assert int(port[w][0]) == int(ref[w][0])
            np.testing.assert_array_equal(port[w][9][:flush_len(
                len(last_flow), h)], ref[w][9].numpy())


# -- 3. the kernels' tables, walked as the kernels walk them ------------------

def model_mesh_kernels(tables, t0, queued, ring, tokens, delivered, target,
                       done_tick, node_sent, inject, inject_target, targets,
                       idle, refill, capacity):
    """A numpy model of csrc/mesh_span.cu followed by the mesh entry of
    csrc/pack_flush.cu, over ``tables`` (MeshTables on the CPU): the tile
    body's restatement (``test_torch_torcells_cases.tile_kernel_span`` with
    the mesh's receive slots) at the kernel's own chunk over the tables'
    own tiles, then the flush from the entry snapshots."""
    tb = {k: getattr(tables, k).numpy() for k in (
        "node_off", "meta", "tiles", "xin", "last_flow_pad", "node_slot")}
    sent_in = node_sent.copy()
    done_in = done_tick[tb["last_flow_pad"]].copy()
    t, q, ring, tok, dl, tg, dt, ns, fwd, cross = tile_kernel_span(
        (t0, queued, ring, tokens, delivered, target, done_tick, node_sent),
        inject, inject_target, targets, idle, refill, capacity,
        tb["node_off"], tb["meta"], tb["tiles"], tables.ring_len,
        xin=tb["xin"], xbuf_len=tables.xbuf_len)
    lf = tb["last_flow_pad"]
    c, h = len(lf), tables.n_nodes
    buf = np.zeros(flush_len(c, h) + 1, np.int64)
    dlast = dt[lf]
    ci = np.flatnonzero((dlast >= 0) & (done_in < 0))
    slot = tb["node_slot"]
    at = np.maximum(slot, 0)
    delta = np.where(slot >= 0, ns[at] - sent_in[at], 0)
    ni = np.flatnonzero(delta)
    buf[:5] = (fwd, dl[lf].sum(), len(ci), len(ni), t)
    buf[5:5 + len(ci)] = ci
    buf[5 + c:5 + c + len(ci)] = dlast[ci]
    buf[5 + 2 * c:5 + 2 * c + len(ni)] = ni
    buf[5 + 2 * c + h:5 + 2 * c + h + len(ni)] = delta[ni]
    buf[-1] = cross
    return (t, q, ring, tok, dl, tg, dt, ns, fwd, buf)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ("fused", "ppermute", "none"))
@pytest.mark.parametrize("n_dev", SHARDS)
def test_kernel_tables_reproduce_the_plain_version(toy, n_dev, mode,
                                                   masked):
    last_flow, queued0, target0 = _inputs(toy)
    h = len(toy.refill)
    lay = _layout(tpart, toy, n_dev)
    lm = _leg_mask(lay, masked)
    tables = tex.MeshTables(lay, toy.ring_len, lay["inv"][last_flow],
                            lay["node_src"], h, mode, lm, "cpu")
    step = tex.make_mesh_span_flush(
        device_mesh(n_dev, device="cpu"), "flows", toy.ring_len, lay,
        lay["inv"][last_flow], lay["node_src"], h, mode=mode, leg_mask=lm)
    fp = len(lay["src"])
    zp = np.zeros(fp, np.int64)
    pq, pt = tpart.pad_state(lay, queued0), tpart.pad_state(lay, target0)
    # a first window with its injections, a 3-boundary superwindow that
    # halts at a completion, then an idle fold with an injection on the
    # boundary it starts at
    windows = ((pq, pt, [40], 0), (zp, zp, [140, 240, 540], 0),
               (pq, pt, [560, 600], 5))
    st = (0,) + _mesh_state(lay, toy.ring_len)
    tst = (0,) + tuple(torch.as_tensor(a) for a in st[1:])
    for inj, inj_t, tv, idle in windows:
        t0 = int(tst[0])
        m = model_mesh_kernels(tables, t0, *st[1:8], inj, inj_t, tv, idle,
                               lay["refill"], lay["capacity"])
        tst = step(t0, *tst[1:8], inj, inj_t, np.array(tv), idle,
                   *_statics(lay))
        for i in range(10):
            np.testing.assert_array_equal(np.asarray(m[i]),
                                          np.asarray(tst[i]),
                                          err_msg=f"{tv} output {i}")
        st = (int(tst[0]),) + tuple(np.asarray(a).copy() for a in tst[1:8])
    assert tables.mode == tex.resolve_mode(lay["exchange"], mode, lm)[0]


def test_kernel_tables_refuse_a_broken_layout(toy):
    lay = dict(_layout(tpart, toy, 3))
    last_flow = _inputs(toy)[0]
    h = len(toy.refill)
    bad = lay["arr_lat"].copy()
    bad[lay["succ_global"][lay["succ_global"] >= 0][0]] = toy.ring_len
    with pytest.raises(ValueError, match="arrival latency"):
        tex.MeshTables(dict(lay, arr_lat=bad), toy.ring_len,
                       lay["inv"][last_flow], lay["node_src"], h)
    bad = lay["flow_node_local"].copy()
    bad[0], bad[1] = bad[1] + 1, bad[0]
    with pytest.raises(ValueError, match="sorted|segment"):
        tex.MeshTables(dict(lay, flow_node_local=bad), toy.ring_len,
                       lay["inv"][last_flow], lay["node_src"], h)


def test_kernel_wrappers_refuse_cpu_tensors(toy):
    lay = _layout(tpart, toy, 2)
    last_flow = _inputs(toy)[0]
    tables = tex.MeshTables(lay, toy.ring_len, lay["inv"][last_flow],
                            lay["node_src"], len(toy.refill))
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        tex.mesh_span(0, z, z, z, z, z, z, z, z, z, [1], 0, z, z, tables)
    with pytest.raises(ValueError, match="CUDA"):
        tex.mesh_pack_flush(z[0], z[0], z[0], z, z, z, z, z, tables)
