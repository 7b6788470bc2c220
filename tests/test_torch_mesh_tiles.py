"""The mesh span kernel's tiled design (csrc/mesh_span.cu around the mesh
cases of csrc/span_tile.cuh), re-stated in numpy and held to the plain
mesh version and the JAX package's mesh step on the CPU.

The kernel has no CPU mode.  ``test_torch_torcells_cases.tile_kernel_span``
re-states it with ``xin``: tiles of whole nodes cut shard by shard
(``exchange.mesh_tile_tables``), a thread per flow in chunks of ``threads
x fpt`` flows with the two block scans, each row's destination a ring
column, an exchange slot of the tick's half of the double-buffered buffer,
or nowhere (a masked leg), the receive of tick t - 1's cell by the
receiving flow at the start of tick t, and the tail pass after the loop.
Chunks of 8 and 32 flows (tiles of 8 and 24), so that nodes run past a
chunk (the toy's relays pace ~10 flows, the long-node table's ~40).  At
D in {2, 3}, in the modes fused, ppermute, ppermute with a leg mask and
none, over three windows: a first with injections, a superwindow that
halts at a targets boundary before its last (where every leg is
exchanged), and an idle fold with an injection; the padding node slots
(no flow) given buckets that fill.  Held bit-exact (int64, no tolerance)
on the nine state outputs and the cross-shard cells to
``mesh_span_torch`` and to the JAX ``make_mesh_span_flush`` (its flush's
trailing slot).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shadow_tpu.ops.torcells_device import DeviceTorCells as JDeviceTorCells
from shadow_tpu.ops.torcells_device import RING_DTYPE
from shadow_tpu.parallel.mesh import device_mesh as jdevice_mesh
from shadow_tpu.parallel.mesh import exchange as jex
from shadow_tpu.parallel.mesh import partition as jpart
from shadow_tpu_torch.parallel.mesh import exchange as tex
from shadow_tpu_torch.parallel.mesh import partition as tpart
from test_torch_torcells_cases import skewed_instance, tile_kernel_span

# (threads, flows a thread, tile flows)
GEOMETRY = ((4, 2, 8), (16, 2, 24))
MODES = ("fused", "ppermute", "ppermute-masked", "none")
STATIC_KEYS = ("flow_node_local", "succ_global", "seg_start_local",
               "refill", "capacity", "arr_lat", "shard_base")


def _toy():
    j = JDeviceTorCells(n_relays=6, n_circuits=20, seed=5,
                        relay_bw_kibps=512, max_latency_ms=20)
    fl = j.flows
    return {"tables": (fl["flow_node"], fl["flow_lat"], fl["flow_succ"],
                       fl["seg_start"], np.asarray(j.refill),
                       np.asarray(j.capacity)),
            "ring_len": j.ring_len, "stage0": fl["flow_stage"] == 0}


def _long_node():
    inst = skewed_instance(40, 4, 2.5, seed=9)
    fl = inst["tables"]
    first = np.zeros(inst["f"], dtype=bool)
    first[inst["first_flow"]] = True
    return {"tables": fl[:6], "ring_len": inst["ring_len"], "stage0": first}


TABLES = {"toy": _toy, "long node": _long_node}


@pytest.fixture(scope="module", params=list(TABLES))
def table(request):
    return request.param, TABLES[request.param]()


def _windows(lay, tab):
    """(inject, inject_target, targets, idle) of the three windows: six
    cells a chain, whose first chains complete at tick 28-46, inside the
    second window's first or second span.  Each window has three
    boundaries (a repeated last one changes nothing), so the JAX step
    compiles once."""
    succ = tab["tables"][2]
    q0 = tpart.pad_state(lay, np.where(tab["stage0"], 6, 0))
    t0 = tpart.pad_state(lay, np.where(succ < 0, 6, 0))
    zp = np.zeros(len(lay["src"]), np.int64)
    return ((q0, t0, [20, 20, 20], 0), (zp, zp, [30, 50, 90], 0),
            (q0, t0, [100, 130, 130], 5))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_dev", (2, 3))
def test_tile_restatement_equals_plain_mesh_and_jax(table, n_dev, mode):
    name, tab = table
    fn, fl, fs, ss, refill, capacity = tab["tables"]
    lr = tab["ring_len"]
    lay = dict(tpart.build_mesh_layout(fn, fl, fs, ss, refill, capacity,
                                       n_dev))
    jlay = jpart.build_mesh_layout(fn, fl, fs, ss, refill, capacity, n_dev)
    # the padding node slots pace no flow (the kernel refills them after its
    # loop): give them buckets that fill, so their refills show
    pad_slot = lay["node_src"] < 0
    assert pad_slot.any()
    lay["refill"] = np.where(pad_slot, 3, lay["refill"])
    lay["capacity"] = np.where(pad_slot, 50, lay["capacity"])
    sched = lay["exchange"]
    masked = mode.endswith("-masked")
    mode = mode.split("-")[0]
    # leg 0 left out: at D = 2 (one leg) every leg, so the mode is none
    lm = tuple(k % 2 == 1 for k in range(sched.legs)) if masked else None
    rmode, active = tex.resolve_mode(sched, mode, lm)
    send_to, xin, xlen = tex.exchange_routes(lay, rmode, active)
    if masked:
        assert (xin == -2).any(), "the mask leaves no leg out"
    last = lay["inv"][np.flatnonzero(fs < 0)]
    h = len(refill)
    jstep = jex.make_mesh_span_flush(
        jdevice_mesh(n_dev, axis_names=("flows",)), "flows", lr, jlay,
        last, jlay["node_src"], h, mode=mode, leg_mask=lm)
    statics = tuple(lay[k] for k in STATIC_KEYS)
    tstatics = tuple(torch.as_tensor(a) for a in statics)
    fp, hp = len(lay["src"]), len(lay["refill"])
    state = (0, np.zeros(fp, np.int64), np.zeros((lr, fp), RING_DTYPE),
             np.where(pad_slot, 10, lay["capacity"]), np.zeros(fp, np.int64),
             np.zeros(fp, np.int64), np.full(fp, -1, np.int64),
             np.zeros(hp, np.int64))
    halted, cross = False, 0
    for inj, inj_t, tv, idle in _windows(lay, tab):
        plain = tex.mesh_span_torch(
            state[0], *(torch.as_tensor(a) for a in state[1:]),
            torch.as_tensor(inj), torch.as_tensor(inj_t), np.array(tv),
            idle, *tstatics, ring_len=lr, schedule=sched, mode=mode,
            leg_mask=lm)
        jout = jstep(np.int64(state[0]),
                     *(jnp.asarray(a) for a in state[1:]), inj, inj_t,
                     np.array(tv), np.int64(idle), *statics)
        for threads, fpt, tile_flows in GEOMETRY:
            node_off, meta, tiles = tex.mesh_tile_tables(lay, send_to, lr,
                                                         tile_flows)
            got = tile_kernel_span(state, inj, inj_t, tv, idle,
                                   lay["refill"], lay["capacity"], node_off,
                                   meta, tiles, lr, threads, fpt, xin=xin,
                                   xbuf_len=max(xlen, 1))
            where = f"{name} D={n_dev} {mode} {tv} {threads}x{fpt}"
            for i in range(10):
                np.testing.assert_array_equal(
                    np.asarray(got[i]), np.asarray(plain[i]),
                    err_msg=f"{where}: output {i} vs plain")
            for i in range(9):
                np.testing.assert_array_equal(
                    np.asarray(got[i]), np.asarray(jout[i]),
                    err_msg=f"{where}: output {i} vs JAX")
            assert got[9] == int(np.asarray(jout[9])[-1]), where
        halted |= got[0] < tv[-1]
        cross += got[9]
        state = tuple(np.array(a) for a in got[:8])
    if mode in ("fused", "ppermute") and not masked:
        # every cell exchanged: chains complete, and the span halts early
        assert halted, "no superwindow halted before its last boundary"
    if rmode == "none":
        assert cross == 0 and (xin < 0).all()
    else:
        assert cross > 0


def test_tiles_stay_inside_a_shard(table):
    """Every tile's nodes and flows lie in one shard; each shard's nodes
    run past a chunk of 8 flows somewhere (the carries)."""
    _name, tab = table
    fn, fl, fs, ss, refill, capacity = tab["tables"]
    lay = tpart.build_mesh_layout(fn, fl, fs, ss, refill, capacity, 3)
    send_to, _xin, _xlen = tex.exchange_routes(
        lay, *tex.resolve_mode(lay["exchange"], "fused"))
    pad, hp = lay["pad"], lay["h_pad"]
    node_off, meta, tiles = tex.mesh_tile_tables(lay, send_to,
                                                 tab["ring_len"], 8)
    assert len(tiles) == 3 * -(-pad // 8) + 1
    for a, b in zip(tiles[:-1], tiles[1:]):
        assert a[1] // pad == (b[1] - 1) // pad or a[1] == b[1]
        assert a[0] // hp == (b[0] - 1) // hp or a[0] == b[0]
    assert np.diff(node_off).max() > 8
    np.testing.assert_array_equal(meta[:, 1], send_to)
