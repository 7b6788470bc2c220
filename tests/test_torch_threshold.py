"""``--tpu-device-threshold N`` with ``--device cpu``.

A hop batch of fewer than N packets goes through the host's numpy hop
(``PacketHopKernel._step_numpy``, the JAX package's bit-identical path
over the host copies of the matrices) and every other batch through the
kernel's plain version, as the JAX package does (shadow_tpu/ops/round_step.py
``launch`` and ``step_sharded``).  Off the CPU the option is refused
(tests/test_torch_refusals.py, tests/test_torch_round_step.py): on the
card every batch launches the kernel.  End to end, the port under ``tpu``
with ``--device cpu`` gives the JAX package's digest, events, rounds and
drops at the same threshold, and with N > 0 both paths were taken.
"""

import numpy as np
import pytest

import shadow_tpu.tools.workloads as jwork
from shadow_tpu.parallel import tpu_policy as jtp
from shadow_tpu_torch.ops import round_step as trs
from shadow_tpu_torch.parallel import tpu_policy as ttp
from shadow_tpu_torch.tools.synth_topology import lossy_complete_graphml
from test_torch_round_step import (BOOTSTRAP_END, DROP_KEY, _columns,
                                   _matrices)
from test_torch_tpu_policy import PARITY, run

THRESHOLD = 100


def _oracle(lat, rel, src, dst, uids, times, barrier):
    """The numpy oracle of a wrapper over (lat, rel) on the CPU."""
    return trs.PacketHopKernel.from_arrays(
        lat, rel, DROP_KEY, BOOTSTRAP_END, "cpu")._step_numpy(
            src, dst, uids, times, barrier)


@pytest.mark.parametrize("n", [THRESHOLD - 1, THRESHOLD],
                         ids=["below", "at"])
def test_bypass_on_the_cpu_takes_batches_below_the_threshold(n):
    lat, rel = _matrices(3)
    kern = trs.PacketHopKernel.from_arrays(lat, rel, DROP_KEY, BOOTSTRAP_END,
                                           "cpu",
                                           device_threshold=THRESHOLD)
    cols = _columns(3, n)
    barrier = BOOTSTRAP_END
    d, k = kern.launch(*cols, barrier).wait()
    below = n < THRESHOLD
    assert (kern.host_calls, kern.device_calls) == (int(below),
                                                    int(not below))
    want = _oracle(lat, rel, *cols, barrier)
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(k, want[1])


@pytest.mark.parametrize("shard_matrix", [False, True],
                         ids=["batch", "rows"])
def test_sharded_bypass_on_the_cpu(shard_matrix):
    lat, rel = _matrices(4)
    kern = trs.ShardedPacketHopKernel.from_arrays(
        lat, rel, DROP_KEY, BOOTSTRAP_END, "cpu", n_devices=4,
        shard_matrix=shard_matrix, device_threshold=THRESHOLD)
    cols = _columns(4, 37)
    d, k = kern.step(*cols, BOOTSTRAP_END + 1)
    assert kern.host_calls == 1 and kern.device_calls == 0
    want = _oracle(lat, rel, *cols, BOOTSTRAP_END + 1)
    np.testing.assert_array_equal(d, want[0])
    np.testing.assert_array_equal(k, want[1])


class _Recorder:
    """A stand-in kernel that records the batch sizes warm-up launches."""

    def __init__(self, threshold):
        self.DEVICE_THRESHOLD = threshold
        self.sizes = []
        self.buckets_seen = set()
        self.device_calls = self.host_calls = 0

    def launch(self, src, *_args):
        self.sizes.append(len(src))
        return self

    def wait(self):
        return None

    def __iter__(self):
        return iter((np.zeros(0), np.zeros(0)))


@pytest.mark.parametrize("threshold,max_batch", [(0, 8192), (64, 8192),
                                                 (300, 8192), (5000, 4096),
                                                 (5000, 8192)])
def test_warmup_skips_buckets_below_the_threshold(threshold, max_batch):
    """The port's warm-up launches the batch sizes the JAX package's
    does: the smallest batch of each bucket that clears the bypass, none
    for a bucket wholly below the threshold."""
    got = []
    for mod in (ttp, jtp):
        pol = mod.TPUSerialPolicy()
        pol._kernel = _Recorder(threshold)
        pol.warmup(None, max_batch=max_batch)
        got.append(pol._kernel.sizes)
    assert got[0] == got[1]
    assert all(n >= threshold for n in got[0])


@pytest.fixture(scope="module")
def small_tor():
    """tor_network(30) (30 clients, 4 servers) on a seeded 12-vertex lossy
    complete GraphML, stoptime 20: its hop batches run from a few packets
    to over a hundred, so a threshold of 64 splits them."""
    return (jwork.tor_network(30, n_clients=30, n_servers=4, stoptime=20),
            lossy_complete_graphml(12, 3))


@pytest.mark.parametrize("threshold", [0, 64])
def test_small_tor_with_a_threshold_equals_jax(small_tor, threshold):
    xml, graph = small_tor
    port = run("torch", xml, "tpu", topology_text=graph,
               tpu_device_threshold=threshold)
    ref = run("jax", xml, "tpu", topology_text=graph,
              tpu_device_threshold=threshold)
    assert ref["drops"] > 0, "the topology must drop packets"
    for key in PARITY:
        assert port[key] == ref[key], key
    assert port["device_calls"] > 0
    if threshold:
        assert port["host_calls"] > 0
    else:
        assert port["host_calls"] == 0
