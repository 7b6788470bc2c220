"""Simulation configuration: hosts, plugins/programs, processes, topology.

Capability parity with the reference's Configuration
(core/support/configuration.c, element/attr schema configuration.h:37-99):

* ``<shadow stoptime bootstraptime environment preload>``
* ``<topology path=.../>`` or inline GraphML cdata
* ``<plugin id path startsymbol>`` — here a *program*: either a registered
  Python app (``python:echo``) or a native plugin path (later rounds)
* ``<host id quantity bandwidthdown bandwidthup iphint citycodehint
  countrycodehint geocodehint typehint socketrecvbuffer socketsendbuffer
  interfacebuffer qdisc loglevel logpcap pcapdir cpufrequency heartbeat...>``
* ``<process plugin starttime stoptime arguments>`` (child of host)

We accept the legacy XML verbatim plus a native YAML/JSON schema with the
same field names, so existing Shadow configs keep working.
"""

from __future__ import annotations

import dataclasses
import json
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional


@dataclasses.dataclass
class ProcessConfig:
    plugin: str = ""                 # program id
    start_time_sec: float = 0.0
    stop_time_sec: float = 0.0       # 0 = run to sim end
    arguments: str = ""
    preload: Optional[str] = None


@dataclasses.dataclass
class FlowConfig:
    """A processless device-plane bulk flow (scale tier, shadow_tpu/scale/):
    the host transfers ``down_bytes``/``up_bytes`` with ``dest`` entirely on
    the device-resident traffic plane — no plugin ever executes on the host,
    so a quantity-expanded group of flow hosts stays struct-of-arrays table
    rows for the whole run (scale/hosttable.py).

    ``path`` is an optional comma-separated relay list in client order
    (guard,middle,exit) for tor-shaped 5-hop chains; absent = the 2-hop
    star shape (dest<->host).  ``tor_path_seed`` instead derives a distinct
    3-relay path per quantity-expanded host from a seeded draw over
    ``tor_relays`` hosts named ``<tor_relay_prefix>1..N`` (and a dest drawn
    over ``tor_servers`` hosts named ``<tor_server_prefix>1..N``), so a
    100k-client Tor shape needs ONE FlowConfig, not 100k.

    ``dest_seed`` draws a distinct 2-hop destination per quantity-expanded
    host from a seeded draw over ``dest_count`` hosts named
    ``<dest_prefix>1..N`` (a draw landing on the host itself shifts to the
    next name, so a group can target its own peers) — the cdn flash-crowd
    (many clients over few origins) and the swarm many-to-many shape need
    ONE FlowConfig per piece, not one per client.  ``stagger``:
    host q's start is start_time_sec + (q %% stagger_waves) * stagger_step_sec."""
    dest: str = ""
    start_time_sec: float = 1.0
    down_bytes: int = 65536
    up_bytes: int = 0
    path: Optional[str] = None
    stagger_waves: int = 1
    stagger_step_sec: float = 0.0
    tor_path_seed: Optional[int] = None
    tor_relays: int = 0
    tor_relay_prefix: str = "relay"
    tor_servers: int = 0
    tor_server_prefix: str = "dest"
    dest_seed: Optional[int] = None
    dest_count: int = 0
    dest_prefix: str = ""


def tokenize_arguments(arguments: str) -> List[str]:
    """Shell-style tokenization of a <process arguments=...> string: a
    superset of the reference's bare strtok-on-spaces (process.c:769) that
    also supports quoted arguments.  Unbalanced quotes fall back to plain
    split.  ONE definition shared by the eager process constructor
    (core/controller.py) and the host table's deferred process specs
    (scale/hosttable.py) so both paths parse identically."""
    if not arguments:
        return []
    if '"' in arguments or "'" in arguments or "\\" in arguments:
        import shlex
        try:
            return shlex.split(arguments)
        except ValueError:
            return arguments.split()
    return arguments.split()


@dataclasses.dataclass
class HostConfig:
    id: str = "host"
    quantity: int = 1
    bandwidth_down_kibps: int = 0    # KiB/s, 0 = from topology vertex
    bandwidth_up_kibps: int = 0
    ip_hint: Optional[str] = None
    city_hint: Optional[str] = None
    country_hint: Optional[str] = None
    geocode_hint: Optional[str] = None
    type_hint: Optional[str] = None
    socket_recv_buffer: int = 0      # 0 = simulator default / autotune
    socket_send_buffer: int = 0
    interface_buffer: int = 0
    qdisc: Optional[str] = None
    tcp_cc: Optional[str] = None     # per-host congestion control
    log_level: Optional[str] = None
    log_pcap: bool = False
    pcap_dir: Optional[str] = None
    cpu_frequency_khz: int = 0       # 0 = disable CPU delay model
    heartbeat_interval_sec: int = 0
    heartbeat_log_level: Optional[str] = None
    heartbeat_log_info: str = "node"
    processes: List[ProcessConfig] = dataclasses.field(default_factory=list)
    flows: List[FlowConfig] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ProgramConfig:
    id: str = ""
    path: str = ""                   # "python:<app-name>" or native .so path
    start_symbol: Optional[str] = None


@dataclasses.dataclass
class Configuration:
    stop_time_sec: float = 60.0
    bootstrap_end_sec: float = 0.0
    environment: Dict[str, str] = dataclasses.field(default_factory=dict)
    preload: Optional[str] = None
    topology_path: Optional[str] = None
    topology_text: Optional[str] = None   # inline GraphML
    programs: List[ProgramConfig] = dataclasses.field(default_factory=list)
    hosts: List[HostConfig] = dataclasses.field(default_factory=list)

    def total_process_count(self) -> int:
        return sum(h.quantity * len(h.processes) for h in self.hosts)


def _to_int(v, default=0) -> int:
    if v is None or v == "":
        return default
    return int(float(v))


def _to_float(v, default=0.0) -> float:
    if v is None or v == "":
        return default
    return float(v)


def _parse_time_sec(v, default=0.0) -> float:
    """Times in configs are seconds (reference XML uses integer seconds;
    we accept fractional)."""
    return _to_float(v, default)


def parse_xml(text: str) -> Configuration:
    """Parse the legacy ``shadow.config.xml`` schema."""
    root = ET.fromstring(text)
    if root.tag != "shadow":
        raise ValueError(f"expected <shadow> root element, got <{root.tag}>")
    cfg = Configuration()
    cfg.stop_time_sec = _parse_time_sec(root.get("stoptime"), 60.0)
    cfg.bootstrap_end_sec = _parse_time_sec(root.get("bootstraptime"), 0.0)
    cfg.preload = root.get("preload")
    env = root.get("environment")
    if env:
        for pair in env.split(";"):
            if "=" in pair:
                k, _, v = pair.partition("=")
                cfg.environment[k] = v

    for el in root:
        if el.tag == "topology":
            cfg.topology_path = el.get("path")
            if el.text and el.text.strip():
                cfg.topology_text = el.text.strip()
        elif el.tag == "plugin":
            cfg.programs.append(ProgramConfig(
                id=el.get("id", ""), path=el.get("path", ""),
                start_symbol=el.get("startsymbol")))
        elif el.tag in ("host", "node"):
            h = HostConfig(
                id=el.get("id", "host"),
                quantity=_to_int(el.get("quantity"), 1),
                bandwidth_down_kibps=_to_int(el.get("bandwidthdown")),
                bandwidth_up_kibps=_to_int(el.get("bandwidthup")),
                ip_hint=el.get("iphint"),
                city_hint=el.get("citycodehint"),
                country_hint=el.get("countrycodehint"),
                geocode_hint=el.get("geocodehint"),
                type_hint=el.get("typehint"),
                socket_recv_buffer=_to_int(el.get("socketrecvbuffer")),
                socket_send_buffer=_to_int(el.get("socketsendbuffer")),
                interface_buffer=_to_int(el.get("interfacebuffer")),
                qdisc=el.get("qdisc"),
                tcp_cc=el.get("tcpcc"),
                log_level=el.get("loglevel"),
                log_pcap=(el.get("logpcap", "").lower() in ("1", "true", "yes")),
                pcap_dir=el.get("pcapdir"),
                cpu_frequency_khz=_to_int(el.get("cpufrequency")),
                heartbeat_interval_sec=_to_int(el.get("heartbeatfrequency")),
                heartbeat_log_level=el.get("heartbeatloglevel"),
                heartbeat_log_info=el.get("heartbeatloginfo", "node"),
            )
            for pel in el:
                if pel.tag in ("process", "application"):
                    h.processes.append(ProcessConfig(
                        plugin=pel.get("plugin", ""),
                        start_time_sec=_parse_time_sec(pel.get("starttime")),
                        stop_time_sec=_parse_time_sec(pel.get("stoptime")),
                        arguments=pel.get("arguments", ""),
                        preload=pel.get("preload")))
                elif pel.tag == "flow":
                    h.flows.append(FlowConfig(
                        dest=pel.get("dest", ""),
                        start_time_sec=_parse_time_sec(pel.get("starttime"), 1.0),
                        down_bytes=_to_int(pel.get("down"), 65536),
                        up_bytes=_to_int(pel.get("up")),
                        path=pel.get("path"),
                        stagger_waves=_to_int(pel.get("staggerwaves"), 1),
                        stagger_step_sec=_to_float(pel.get("staggerstep")),
                        tor_path_seed=(_to_int(pel.get("torpathseed"))
                                       if pel.get("torpathseed") else None),
                        tor_relays=_to_int(pel.get("torrelays")),
                        tor_relay_prefix=pel.get("torrelayprefix", "relay"),
                        tor_servers=_to_int(pel.get("torservers")),
                        tor_server_prefix=pel.get("torserverprefix", "dest"),
                        dest_seed=(_to_int(pel.get("destseed"))
                                   if pel.get("destseed") else None),
                        dest_count=_to_int(pel.get("destcount")),
                        dest_prefix=pel.get("destprefix", "")))
            cfg.hosts.append(h)
    return cfg


def parse_dict(d: dict) -> Configuration:
    """Parse the native YAML/JSON schema (same field names, nested)."""
    cfg = Configuration()
    g = d.get("general", d)
    cfg.stop_time_sec = _parse_time_sec(g.get("stop_time"), 60.0)
    cfg.bootstrap_end_sec = _parse_time_sec(g.get("bootstrap_end_time"), 0.0)
    cfg.environment = dict(g.get("environment", {}))
    topo = d.get("network", d.get("topology", {}))
    if isinstance(topo, str):
        cfg.topology_path = topo
    elif isinstance(topo, dict):
        graph = topo.get("graph", topo)
        cfg.topology_path = graph.get("path")
        cfg.topology_text = graph.get("inline") or graph.get("text")
    for pid, p in (d.get("programs", {}) or {}).items():
        if isinstance(p, str):
            cfg.programs.append(ProgramConfig(id=pid, path=p))
        else:
            cfg.programs.append(ProgramConfig(id=pid, path=p.get("path", ""),
                                              start_symbol=p.get("start_symbol")))
    hosts = d.get("hosts", {})
    items = hosts.items() if isinstance(hosts, dict) else ((h.get("id", f"host{i}"), h) for i, h in enumerate(hosts))
    for hid, h in items:
        hc = HostConfig(
            id=hid,
            quantity=_to_int(h.get("quantity"), 1),
            bandwidth_down_kibps=_to_int(h.get("bandwidth_down")),
            bandwidth_up_kibps=_to_int(h.get("bandwidth_up")),
            ip_hint=h.get("ip_addr") or h.get("ip_hint"),
            city_hint=h.get("city_code_hint"),
            country_hint=h.get("country_code_hint"),
            geocode_hint=h.get("geocode_hint"),
            type_hint=h.get("type_hint"),
            socket_recv_buffer=_to_int(h.get("socket_recv_buffer")),
            socket_send_buffer=_to_int(h.get("socket_send_buffer")),
            interface_buffer=_to_int(h.get("interface_buffer")),
            qdisc=h.get("qdisc"),
            tcp_cc=h.get("tcpcc") or h.get("tcp_cc"),
            log_level=h.get("log_level"),
            log_pcap=bool(h.get("pcap", False)),
            pcap_dir=h.get("pcap_dir"),
            cpu_frequency_khz=_to_int(h.get("cpu_frequency")),
            heartbeat_interval_sec=_to_int(h.get("heartbeat_interval")),
        )
        for p in h.get("processes", []):
            hc.processes.append(ProcessConfig(
                plugin=p.get("path", p.get("plugin", "")),
                start_time_sec=_parse_time_sec(p.get("start_time")),
                stop_time_sec=_parse_time_sec(p.get("stop_time")),
                arguments=p.get("args", p.get("arguments", "")) if not isinstance(
                    p.get("args"), list) else " ".join(str(a) for a in p["args"]),
            ))
        for fl in h.get("flows", []):
            hc.flows.append(FlowConfig(
                dest=fl.get("dest", ""),
                start_time_sec=_parse_time_sec(fl.get("start_time"), 1.0),
                down_bytes=_to_int(fl.get("down_bytes"), 65536),
                up_bytes=_to_int(fl.get("up_bytes")),
                path=fl.get("path"),
                stagger_waves=_to_int(fl.get("stagger_waves"), 1),
                stagger_step_sec=_to_float(fl.get("stagger_step_sec")),
                tor_path_seed=(_to_int(fl.get("tor_path_seed"))
                               if fl.get("tor_path_seed") is not None
                               else None),
                tor_relays=_to_int(fl.get("tor_relays")),
                tor_relay_prefix=fl.get("tor_relay_prefix", "relay"),
                tor_servers=_to_int(fl.get("tor_servers")),
                tor_server_prefix=fl.get("tor_server_prefix", "dest"),
                dest_seed=(_to_int(fl.get("dest_seed"))
                           if fl.get("dest_seed") is not None else None),
                dest_count=_to_int(fl.get("dest_count")),
                dest_prefix=fl.get("dest_prefix", "")))
        cfg.hosts.append(hc)
    return cfg


def load(path: str) -> Configuration:
    with open(path, "r") as f:
        text = f.read()
    if path.endswith(".xml") or text.lstrip().startswith("<"):
        return parse_xml(text)
    if path.endswith(".json"):
        return parse_dict(json.loads(text))
    import yaml
    return parse_dict(yaml.safe_load(text))
