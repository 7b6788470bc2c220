"""Controller: top-level simulation driver (reference Master, core/master.c).

Loads configuration + topology, registers programs and hosts into the
Engine, computes the lookahead, runs the simulation, reports results
(master_run :400 flow).

The port runs the ``tpu`` policy's hop on the device, device-mode
clients' bulk cells and the HostTable tier's processless flows on the
device traffic plane (parallel/device_plane.py), boots hosts as HostTable
rows under ``--host-table`` (scale/), attaches the C data plane where the
reference does (parallel/native_plane.py, built from ``native/`` into the
port's own ``native/`` directory: utils/native_build.py) and runs
``--processes N`` as N shard processes (parallel/procs.py).  Paths it has
not ported refuse with NotImplementedError naming their ROADMAP item,
before any simulation work; they never quietly take another path
(:func:`refuse_unported`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..apps import registry as app_registry
from ..device import resolve_device
from ..host.host import Host, HostParams
from ..process.process import Process
from ..routing.address import ip_to_int
from ..routing.topology import Topology, single_vertex_topology
from ..utils import native_build
from . import stime
from .configuration import Configuration, tokenize_arguments
from .engine import Engine
from .logger import get_logger
from .options import Options


def has_device_clients(config: Configuration) -> bool:
    """Whether any traffic runs on the device traffic plane: a device-mode
    client process (its bulk transfer) or a processless ``<flow>`` (the
    HostTable tier's generated scenarios)."""
    for hc in config.hosts:
        if hc.flows:
            return True
        for pc in hc.processes:
            args = tokenize_arguments(pc.arguments)
            if args and args[0] == "client" and "device" in args:
                return True
    return False


def refuse_unported(options: Options, config: Configuration) -> None:
    """Raise NotImplementedError for the configurations whose paths the
    port does not run yet."""
    if getattr(options, "tpu_device_threshold", 0) > 0 \
            and getattr(options, "device", "cuda") != "cpu":
        raise NotImplementedError(
            "--tpu-device-threshold > 0 computes small hop batches on the "
            "host; with --device cuda every batch goes through the kernel, "
            "so the bypass runs only with --device cpu")


class Controller:
    def __init__(self, options: Options, config: Configuration):
        refuse_unported(options, config)
        if options.scheduler_policy == "tpu" or (
                has_device_clients(config)
                and getattr(options, "device_plane", "device") == "device"):
            # fail before setup, not at the first launch, when the
            # requested device is missing (device.py never falls back)
            resolve_device(getattr(options, "device", "cuda"))
        # the retransmit tally's library, before the first TCP socket asks
        # for it (make_tally remembers its first answer)
        native_build.ensure_tally()
        self.options = options
        self.config = config
        self.topology = self._load_topology()
        self.engine = Engine(options, self.topology)
        self._program_paths: Dict[str, str] = {}

    def _load_topology(self) -> Topology:
        cfg = self.config
        if cfg.topology_text:
            return Topology.from_graphml(cfg.topology_text)
        if cfg.topology_path:
            path = cfg.topology_path
            if not os.path.isabs(path) and self.options.config_path:
                base = os.path.dirname(os.path.abspath(self.options.config_path))
                cand = os.path.join(base, path)
                if os.path.exists(cand):
                    path = cand
            return Topology.from_file(path)
        return single_vertex_topology()

    def _validated_tcp_cc(self, hc):
        """Per-host <host tcpcc="..."> must name a known CC kind at
        CONFIG time — not crash as a KeyError in the native plane or a
        mid-run ValueError at first socket creation."""
        from .options import TCP_CC_KINDS
        if hc.tcp_cc and hc.tcp_cc not in TCP_CC_KINDS:
            raise ValueError(
                f"host {hc.id!r}: unknown tcpcc={hc.tcp_cc!r} "
                f"(choices: {', '.join(TCP_CC_KINDS)})")
        return hc.tcp_cc

    def _host_params_kwargs(self, hc) -> dict:
        """The HostParams keyword set shared by a whole config entry —
        everything but the per-host name and the topology-resolved
        bandwidths.  ONE construction point for the eager path and the
        HostTable's deferred materialization, so the two can never drift
        (the table-vs-object digest parity gates lean on it)."""
        opts = self.options
        return dict(
            qdisc=hc.qdisc or opts.interface_qdisc,
            tcp_cc=self._validated_tcp_cc(hc),
            router_queue=opts.router_queue,
            # 0 means "default start size + autotune", never a
            # zero-byte buffer (a 0 advertised window would
            # deadlock every transfer at handshake)
            recv_buf_size=(hc.socket_recv_buffer
                           or opts.socket_recv_buffer or 174760),
            send_buf_size=(hc.socket_send_buffer
                           or opts.socket_send_buffer or 131072),
            autotune_recv=opts.socket_autotune and not hc.socket_recv_buffer,
            autotune_send=opts.socket_autotune and not hc.socket_send_buffer,
            cpu_frequency_khz=hc.cpu_frequency_khz,
            cpu_threshold_ns=opts.cpu_threshold_ns,
            cpu_precision_ns=opts.cpu_precision_ns,
            interface_buffer=hc.interface_buffer or opts.interface_buffer,
            heartbeat_interval_sec=(hc.heartbeat_interval_sec
                                    or opts.heartbeat_interval_sec),
            log_pcap=hc.log_pcap,
            pcap_dir=hc.pcap_dir or opts.pcap_dir,
            ip_hint=hc.ip_hint, city_hint=hc.city_hint,
            country_hint=hc.country_hint, geocode_hint=hc.geocode_hint,
            type_hint=hc.type_hint,
            log_level=hc.log_level,
            heartbeat_log_level=hc.heartbeat_log_level)

    def _table_mode(self) -> bool:
        """Whether hosts boot as HostTable rows (scale/hosttable.py):
        --host-table on/off, or auto = on exactly when the config carries
        processless device flows (generated scale scenarios) — existing
        workloads keep the eager path."""
        mode = getattr(self.options, "host_table", "auto")
        if mode == "on":
            return True
        if mode == "off":
            return False
        return any(hc.flows for hc in self.config.hosts)

    def setup(self) -> None:
        """Register programs and hosts (master.c:279-392)."""
        opts = self.options
        # <shadow environment="K=V;..."> is injected into every native
        # plugin's environment (reference main.c:474-524); a config-level
        # preload path rides the same mechanism (main.c scrubs/builds
        # LD_PRELOAD the same way)
        self.engine.plugin_environment = dict(self.config.environment or {})
        if self.config.preload:
            prior = self.engine.plugin_environment.get("LD_PRELOAD", "")
            self.engine.plugin_environment["LD_PRELOAD"] = (
                self.config.preload + (" " + prior if prior else ""))
        for prog in self.config.programs:
            self._program_paths[prog.id] = prog.path

        from ..scale.memprof import BootProfile
        profile = BootProfile()
        profile.snapshot()
        if self._table_mode():
            self._setup_table_hosts()
        else:
            self._setup_eager_hosts()
        profile.commit(self.engine.total_host_count())
        profile.install(self.engine)
        self.topology.finalize()
        # the C data plane (parallel/native_plane.py): TCP/UDP pipeline +
        # interfaces + router + hop execute natively for eligible serial
        # runs; Python keeps the control plane.  No-op (with a logged
        # reason) when ineligible in auto mode.
        from ..parallel.native_plane import attach as attach_native
        attach_native(self.engine)

    def _setup_eager_hosts(self) -> None:
        """The classic boot path: one Host object per quantity expansion."""
        for hc in self.config.hosts:
            if hc.flows:
                raise ValueError(
                    f"host {hc.id!r} has device flows; flows need the host "
                    "table (--host-table=on or auto)")
            kw = self._host_params_kwargs(hc)
            for q in range(hc.quantity):
                name = hc.id if hc.quantity == 1 else f"{hc.id}{q + 1}"
                params = HostParams(
                    name=name,
                    bw_down_kibps=hc.bandwidth_down_kibps,
                    bw_up_kibps=hc.bandwidth_up_kibps, **kw)
                host = Host(self.engine.next_host_id(), params,
                            self.engine.root_key)
                requested_ip = ip_to_int(hc.ip_hint) if hc.ip_hint else None
                self.engine.add_host(host, requested_ip)
                for pc in hc.processes:
                    self._add_process(host, pc)

    def _setup_table_hosts(self) -> None:
        """Scale boot path: every host becomes a HostTable row; Host
        objects materialize lazily (scale/hosttable.py)."""
        from ..scale.hosttable import HostTable
        total = sum(hc.quantity for hc in self.config.hosts)
        table = HostTable(self.engine, total)
        self.engine.host_table = table
        for hc in self.config.hosts:
            table.reserve_group(hc, self._host_params_kwargs(hc),
                                self._add_process)
            grp = table.groups[-1]
            for pc in hc.processes:
                path = self._program_paths.get(pc.plugin, pc.plugin)
                table.add_group_process_spec(
                    grp, pc, path, tokenize_arguments(pc.arguments))
        table.freeze()

    def _add_process(self, host: Host, pc) -> None:
        path = self._program_paths.get(pc.plugin, pc.plugin)
        app_main = app_registry.resolve(path)
        args = tokenize_arguments(pc.arguments)
        stop_ns = stime.from_seconds(pc.stop_time_sec) if pc.stop_time_sec else 0
        proc = Process(host, f"{host.name}.{pc.plugin}", app_main, args,
                       start_time_ns=stime.from_seconds(pc.start_time_sec),
                       stop_time_ns=stop_ns, preload=pc.preload)
        proc.app_path = path    # device-plane scan matches on resolved app

    def run(self) -> int:
        self.setup()
        # device-mode clients in the workload promote their bulk traffic to
        # the device-resident plane (parallel/device_plane.py); None when
        # the workload has none — the engine hooks are then inert
        from ..parallel.device_plane import build_plane_from_engine
        self.engine.device_plane = build_plane_from_engine(
            self.engine, mode=getattr(self.options, "device_plane", "device"))
        return self.engine.run()


def run_simulation(options: Options, config: Configuration) -> int:
    """One-call entry used by the CLI and tests.  ``--processes N`` (N >= 2)
    routes to the sharded multi-process coordinator."""
    if getattr(options, "processes", 0) >= 2:
        refuse_unported(options, config)
        # the parent builds the tally before it spawns, so that its N
        # shards find it built
        native_build.ensure_tally()
        from ..parallel.procs import run_sharded
        return run_sharded(options, config)
    return Controller(options, config).run()
