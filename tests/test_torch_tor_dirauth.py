"""The Tor app's directory authority takes every relay's descriptor when
all of them publish at once.

Tor listens with the system's SOMAXCONN, and the port's authority does
too (a backlog of 4,096).  The JAX package's authority still listens with
a backlog of 64: a deliberate difference.  With 100 relays publishing at
2 s, a backlog of 64 drops the SYNs of 36 of them, which retry only after
the 1 s retransmission timeout, past the 3 s stop: the JAX package's
authority holds 64 relays there, the port's all 100.
"""

import pytest

RELAYS = 100
STOP = 3


def _registered(pkg: str):
    import importlib
    conf = importlib.import_module(pkg + ".core.configuration")
    controller = importlib.import_module(pkg + ".core.controller")
    options = importlib.import_module(pkg + ".core.options")
    workloads = importlib.import_module(pkg + ".tools.workloads")
    cfg = conf.parse_xml(workloads.tor_network(
        RELAYS, n_clients=1, n_servers=1, stoptime=STOP, seed=3,
        dirauth=True))
    kw = dict(workers=0, seed=1, heartbeat_interval_sec=0,
              stop_time_sec=STOP, log_level="warning")
    if pkg == "shadow_tpu_torch":
        kw["device"] = "cpu"
    ctl = controller.Controller(options.Options(**kw), cfg)
    ctl.run()
    return ctl.engine.host_by_name("dirauth").processes[0].app_state


def test_authority_registers_every_relay_publishing_at_once():
    st = _registered("shadow_tpu_torch")
    assert sorted(st) == sorted(f"relay{i}" for i in range(RELAYS))
    # every descriptor arrived within the first second of publishing
    assert all(2 * 10 ** 9 <= t < 3 * 10 ** 9
               for t in st.published_ns.values())


@pytest.mark.parametrize("pkg,held", [("shadow_tpu_torch", RELAYS),
                                      ("shadow_tpu", 64)])
def test_backlog_differs_from_the_jax_package(pkg, held):
    assert len(_registered(pkg)) == held
