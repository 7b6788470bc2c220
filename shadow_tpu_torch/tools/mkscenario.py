"""mkscenario: build, inspect, and run generated scale scenarios.

The scale tier's scenario generators (shadow_tpu/scale/genscen.py) emit
``Configuration`` objects directly — this CLI is the operator surface:

    python -m shadow_tpu_torch.tools.mkscenario star100k --summary
    python -m shadow_tpu_torch.tools.mkscenario star2k --xml > star2k.xml
    python -m shadow_tpu_torch.tools.mkscenario star100k --run \
        [--stop-time N] [--device-plane numpy] [--metrics path.jsonl]

``--summary`` (default) prints one JSON line of scenario shape +
content digest; ``--xml`` dumps legacy XML (refused above 50k hosts —
emitting multi-megabyte XML is exactly what the generators exist to
avoid; the ``<flow>`` element round-trips through configuration.parse_xml
for the sizes where XML makes sense); ``--run`` executes the scenario
with the host table on and prints the run's scale metrics, propagating
the child engine's exit code.  ``--seed N`` pins BOTH the seeded
families' structural draws (tor circuits, cdn/swarm partner graphs) and
the engine seed, so a fuzz-discovered scenario replays from the CLI.
"""

from __future__ import annotations

import json
import sys
from typing import List

from ..core.configuration import Configuration

XML_HOST_CAP = 50_000


def config_to_xml(cfg: Configuration) -> str:
    """Legacy-schema XML for a generated Configuration (small scenarios,
    interchange/debugging).  Only the fields the generators emit."""
    total = sum(h.quantity for h in cfg.hosts)
    if total > XML_HOST_CAP:
        raise ValueError(
            f"refusing to emit XML for {total} hosts (> {XML_HOST_CAP}); "
            "run the Configuration directly (--run) instead")
    lines = [f'<shadow stoptime="{int(cfg.stop_time_sec)}">']
    for hc in cfg.hosts:
        attrs = [f'id="{hc.id}"']
        if hc.quantity != 1:
            attrs.append(f'quantity="{hc.quantity}"')
        if hc.bandwidth_down_kibps:
            attrs.append(f'bandwidthdown="{hc.bandwidth_down_kibps}"')
        if hc.bandwidth_up_kibps:
            attrs.append(f'bandwidthup="{hc.bandwidth_up_kibps}"')
        body = []
        for pc in hc.processes:
            p = [f'plugin="{pc.plugin}"']
            if pc.start_time_sec:
                p.append(f'starttime="{pc.start_time_sec:g}"')
            if pc.stop_time_sec:
                p.append(f'stoptime="{pc.stop_time_sec:g}"')
            if pc.arguments:
                p.append(f'arguments="{pc.arguments}"')
            body.append(f'    <process {" ".join(p)} />')
        for fc in hc.flows:
            f = [f'dest="{fc.dest}"', f'starttime="{fc.start_time_sec:g}"',
                 f'down="{fc.down_bytes}"']
            if fc.up_bytes:
                f.append(f'up="{fc.up_bytes}"')
            if fc.path:
                f.append(f'path="{fc.path}"')
            if fc.stagger_waves > 1:
                f.append(f'staggerwaves="{fc.stagger_waves}"')
                f.append(f'staggerstep="{fc.stagger_step_sec:g}"')
            if fc.tor_path_seed is not None:
                f.append(f'torpathseed="{fc.tor_path_seed}"')
                f.append(f'torrelays="{fc.tor_relays}"')
                f.append(f'torrelayprefix="{fc.tor_relay_prefix}"')
                f.append(f'torservers="{fc.tor_servers}"')
                f.append(f'torserverprefix="{fc.tor_server_prefix}"')
            if fc.dest_seed is not None:
                f.append(f'destseed="{fc.dest_seed}"')
                f.append(f'destcount="{fc.dest_count}"')
                f.append(f'destprefix="{fc.dest_prefix}"')
            body.append(f'    <flow {" ".join(f)} />')
        if body:
            lines.append(f'  <host {" ".join(attrs)}>')
            lines.extend(body)
            lines.append('  </host>')
        else:
            lines.append(f'  <host {" ".join(attrs)} />')
    lines.append('</shadow>')
    return "\n".join(lines) + "\n"


def summarize(cfg: Configuration) -> dict:
    from ..scale.genscen import config_digest
    return {
        "hosts": sum(h.quantity for h in cfg.hosts),
        "groups": len(cfg.hosts),
        "processes": cfg.total_process_count(),
        "flows": sum(h.quantity * len(h.flows) for h in cfg.hosts),
        "stop_time_sec": cfg.stop_time_sec,
        "digest": config_digest(cfg),
    }


def run_scenario(cfg: Configuration, argv: List[str]) -> int:
    """Execute a generated scenario with scale defaults: host table on,
    heartbeats off (quiet rows stay rows), pure-Python control plane."""
    from ..core.controller import run_simulation
    from ..core.logger import SimLogger, set_logger
    from ..core.options import build_parser, Options
    import dataclasses
    ns = build_parser().parse_args(["dummy.xml"] + argv)
    set_logger(SimLogger(level=ns.log_level or "message"))
    opts = Options()
    for f in dataclasses.fields(Options):
        v = getattr(ns, f.name, None)
        if v is not None:
            setattr(opts, f.name, v)
    opts.config_path = None
    if ns.stop_time_sec is not None:
        cfg.stop_time_sec = ns.stop_time_sec
    opts.stop_time_sec = int(cfg.stop_time_sec)
    opts.host_table = "on"
    if "--heartbeat-frequency" not in argv:
        opts.heartbeat_interval_sec = 0
    return run_simulation(opts, cfg)


def main(argv: List[str]) -> int:
    from ..scale.genscen import NAMED, build, family_fn
    if not argv or argv[0].startswith("-"):
        print(f"usage: python -m shadow_tpu_torch.tools.mkscenario "
              f"{{{','.join(sorted(NAMED))}}} [--summary|--xml|--run] "
              "[--seed N] [run options]", file=sys.stderr)
        return 2
    name, rest = argv[0], argv[1:]
    overrides = {}
    seed_args = [a for a in rest
                 if a == "--seed" or a.startswith("--seed=")]
    if seed_args:
        # --seed parameterizes the scenario BUILDER for the seeded
        # families (tor/cdn/swarm path+partner draws) so fuzz-discovered
        # scenarios replay from the CLI; run_scenario parses the same flag
        # again for the engine seed, so one value pins both draws.  Both
        # argparse spellings (--seed N / --seed=N) must hit the builder —
        # a silently-skipped override would replay a DIFFERENT scenario.
        import inspect
        try:
            # LAST occurrence wins, matching run_scenario's argparse —
            # builder and engine must never read different seeds
            a = seed_args[-1]
            seed = int(a.partition("=")[2]) if "=" in a \
                else int(rest[len(rest) - 1 - rest[::-1].index("--seed")
                              + 1])
        except (IndexError, ValueError):
            print("error: --seed needs an integer", file=sys.stderr)
            return 2
        try:
            if "seed" in inspect.signature(family_fn(name)).parameters:
                overrides["seed"] = seed
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    try:
        cfg = build(name, **overrides)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if "--xml" in rest:
        try:
            sys.stdout.write(config_to_xml(cfg))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0
    if "--run" in rest:
        # the child engine's exit code propagates verbatim — a failed
        # fuzz replay must fail the CLI, not report rc 0
        return run_scenario(cfg, [a for a in rest if a != "--run"])
    print(json.dumps({"scenario": name, **summarize(cfg)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
