"""The packet-hop CUDA kernel on the card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these tests skip where there is no GPU or
no nvcc, with the reason; on a machine with an H100 they run with
``python -m pytest tests/test_torch_cuda.py``.  They hold the kernel
bit-exact against its plain torch version on the same card tensors, check
the async launch path (pinned buffers, own stream, several chunks pending at
once) and the wrapper's argument checks, and run the small tor config
end to end on the card against the port's CPU run.
"""

import numpy as np
import pytest
import torch

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

    before = rs.packet_hop_packed.launches
    card = run("cuda")
    launched = rs.packet_hop_packed.launches - before
    cpu = run("cpu")
    assert card == cpu
    assert launched == card[3] > 0 and card[4] == 0
