"""The port's sharded packet hop (ShardedPacketHopKernel over D shards on
one device) on the CPU, against the JAX package's over its 8 virtual XLA
devices.

1. The hop: the same seeded batches through the JAX package's
   ``ShardedPacketHopKernel`` and the port's, in both layouts (the batch
   split into D slices; ``shard_matrix``: the path matrices split into D
   row slices, the rows padded to a multiple of D), at D in {8, 3, 2} and
   A = 37 (not a multiple of D), give the same deliver times and keep
   flags, bit for bit — and those of the unsharded hop.  The bucket is the
   JAX package's: at least D * MIN_BUCKET, a multiple of D.
2. The engine: the echo config of tests/test_scaleout.py and the small
   device-client tor config under ``--scheduler-policy=tpu`` with
   ``--tpu-devices D`` (and ``--tpu-shard-matrix``) end in the JAX
   package's state digest and event count, and every hop batch went
   through the sharded kernel.
"""

import textwrap

import numpy as np
import pytest
import torch

from shadow_tpu.ops.round_step import \
    ShardedPacketHopKernel as JShardedPacketHopKernel
from shadow_tpu_torch.ops import round_step as trs
from test_torch_device_plane import PACKAGES, fresh_logger

A = 37
DROP_KEY = 0xC0FFEE123456789A
BOOTSTRAP_END = 5_000_000_000
BARRIER = 7_000_000_000


class _Topo:
    """The two packages' Topology surface the hop kernels read."""

    def __init__(self, lat, rel):
        import jax.numpy as jnp
        self.latency_ns = lat
        self.reliability = rel
        self._jnp = jnp

    def device_tensors(self, device=None):
        if device is None:          # the JAX package's signature
            return (self._jnp.asarray(self.latency_ns),
                    self._jnp.asarray(self.reliability))
        return (torch.as_tensor(self.latency_ns, device=device),
                torch.as_tensor(self.reliability, device=device))


@pytest.fixture(scope="module")
def topo():
    rng = np.random.default_rng(3)
    lat = rng.integers(1_000_000, 50_000_000, (A, A)).astype(np.int64)
    rel = rng.uniform(0.5, 1.0, (A, A)).astype(np.float32)
    rel[rng.random((A, A)) < 0.3] = 1.0
    return _Topo(lat, rel)


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, A, n), rng.integers(0, A, n),
            rng.integers(0, 2 ** 63, n, dtype=np.int64).astype(np.uint64),
            rng.integers(0, 10_000_000_000, n))


@pytest.mark.parametrize("shard_matrix", [False, True])
@pytest.mark.parametrize("n_dev", [8, 3, 2])
def test_sharded_hop_equals_jax_and_unsharded(topo, n_dev, shard_matrix):
    j = JShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, n_dev,
                                shard_matrix=shard_matrix)
    t = trs.ShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, n_dev,
                                   shard_matrix=shard_matrix, device="cpu")
    one = trs.PacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, "cpu")
    launches = trs.packet_hop_sharded.launches
    for n, seed in ((5, 1), (300, 2), (3000, 3)):
        b = _batch(n, seed)
        jd, jk = j.step(*b, BARRIER)
        td, tk = t.step(*b, BARRIER)
        od, ok = one.step(*b, BARRIER)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(td, od)
        np.testing.assert_array_equal(tk, ok)
        assert 0 < tk.sum() < n or n < 10
        bk = t.bucket(n)
        assert bk % n_dev == 0 and bk >= max(n, n_dev * trs.MIN_BUCKET)
    assert t.buckets_seen == j.buckets_seen
    if shard_matrix:
        per = -(-A // n_dev)
        assert len(t.lat_rows) == n_dev
        assert all(r.shape == (per, A) for r in t.lat_rows)
        assert len({r.data_ptr() for r in t.lat_rows}) == n_dev
    # the CPU runs the plain versions: no kernel was launched
    assert trs.packet_hop_sharded.launches == launches


def test_padded_columns_equal_jax(topo):
    j = JShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, 3)
    t = trs.ShardedPacketHopKernel(topo, DROP_KEY, BOOTSTRAP_END, 3,
                                   device="cpu")
    b = _batch(100, 9)
    jc = j._padded_batch(*b, 768)
    tc = t.padded_batch(*b, 768)
    # the same bytes (the uid halves are uint32 there, int32 bit patterns
    # here)
    for x, y in zip(tc, jc):
        np.testing.assert_array_equal(x.view(np.uint8),
                                      np.asarray(y).view(np.uint8))
    # one byte buffer holds the six columns as views
    buf = torch.zeros(768 * trs._ColumnPool.COL_BYTES, dtype=torch.uint8)
    views = trs.column_views(buf, 768)
    t.padded_batch(*b, 768, out=views)
    for v, c in zip(views, tc):
        np.testing.assert_array_equal(v.numpy(), c)


SIM_XML = textwrap.dedent("""\
    <shadow stoptime="60">
      <plugin id="echo" path="python:echo" />
      <host id="server"><process plugin="echo" starttime="1" arguments="udp server 8000" /></host>
      <host id="c" quantity="6">
        <process plugin="echo" starttime="2" arguments="udp client server 8000 6 512" />
      </host>
    </shadow>
""")


def _engine_run(pkg, xml, stop, **kw):
    conf, ctl, opt, ckpt = PACKAGES[pkg]
    cfg = conf.parse_xml(xml)
    cfg.stop_time_sec = stop
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    c = ctl.Controller(opt.Options(workers=0, seed=3, stop_time_sec=stop,
                                   log_level="warning", **kw), cfg)
    fresh_logger(pkg)
    assert c.run() == 0
    return c


@pytest.mark.parametrize("n_dev,shard_matrix", [(8, False), (8, True),
                                                (3, True)])
def test_sharded_tpu_policy_equals_jax(n_dev, shard_matrix):
    kw = dict(scheduler_policy="tpu", tpu_devices=n_dev,
              tpu_shard_matrix=shard_matrix)
    port = _engine_run("torch", SIM_XML, 60, **kw)
    ref = _engine_run("jax", SIM_XML, 60, **kw)
    tckpt, jckpt = PACKAGES["torch"][3], PACKAGES["jax"][3]
    assert tckpt.state_digest(port.engine) == jckpt.state_digest(ref.engine)
    assert port.engine.events_executed == ref.engine.events_executed
    kern = port.engine.scheduler.policy._kernel
    assert isinstance(kern, trs.ShardedPacketHopKernel)
    assert kern.n_devices == n_dev and kern.shard_matrix == shard_matrix
    assert kern.device_calls > 0 and kern.host_calls == 0


def test_device_clients_on_the_mesh_under_tpu_equal_jax():
    """Both sharded paths at once: the plane on the mesh and the hop
    matrix-sharded, on the small device-client tor config."""
    from test_torch_device_plane import XML, STOP
    kw = dict(scheduler_policy="tpu", tpu_devices=4, tpu_shard_matrix=True,
              device_plane="device")
    port = _engine_run("torch", XML, STOP, **kw)
    ref = _engine_run("jax", XML, STOP, **kw)
    tckpt, jckpt = PACKAGES["torch"][3], PACKAGES["jax"][3]
    assert tckpt.state_digest(port.engine) == jckpt.state_digest(ref.engine)
    plane = port.engine.device_plane
    assert plane._shard is not None and plane._shard["n_shards"] == 4
    assert port.engine.metrics.scrape()["mesh.host_bounces"] == 0
    assert port.engine.scheduler.policy._kernel.shard_matrix
