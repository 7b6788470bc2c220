"""shadow-tpu-torch command-line entry point (reference src/main/core/main.c
main_runShadow, minus the LD_PRELOAD/exec bootstrap, which the port has not
ported).

Usage:
    python -m shadow_tpu_torch.cli [options] config.xml|config.yaml
    python -m shadow_tpu_torch.cli --test      # built-in example simulation

``--scheduler-policy=tpu`` runs every round's packet hops through the CUDA
kernel; ``--device cpu`` runs its plain torch version instead.
"""

from __future__ import annotations

import os
import sys
import textwrap
from typing import List, Optional

from .core import configuration
from .core.controller import run_simulation
from .core.logger import SimLogger, set_logger
from .core.options import parse_args

# The reference's --test serves /bin/ls (~100KB era-adjusted: we use 16KB)
# to 1000 clients x 10 downloads via a filetransfer plugin (examples.c:10);
# same workload shape here over the full TCP stack.
BUILTIN_TEST_CONFIG = textwrap.dedent("""\
    <shadow stoptime="600">
      <plugin id="filetransfer" path="python:filetransfer" />
      <plugin id="echo" path="python:echo" />
      <host id="server" bandwidthdown="1048576" bandwidthup="1048576">
        <process plugin="filetransfer" starttime="1" arguments="server 80 16384" />
      </host>
      <host id="client" quantity="100" bandwidthdown="10240" bandwidthup="5120">
        <process plugin="filetransfer" starttime="2"
                 arguments="client server 80 10" />
      </host>
      <host id="udpclient" bandwidthdown="10240" bandwidthup="5120">
        <process plugin="echo" starttime="2"
                 arguments="udp client server2 8000 5 512" />
      </host>
      <host id="server2">
        <process plugin="echo" starttime="1" arguments="udp server 8000" />
      </host>
    </shadow>
""")


def main(argv: Optional[List[str]] = None) -> int:
    opts = parse_args(argv)
    set_logger(SimLogger(level=opts.log_level))
    # fail fast on supervision/recovery flags that could only error after
    # minutes of setup: a bad --resume target or malformed --fault-inject
    if opts.resume_path and not (os.path.isfile(opts.resume_path)
                                 or os.path.isdir(opts.resume_path)):
        print(f"error: --resume target not found: {opts.resume_path}",
              file=sys.stderr)
        return 2
    if opts.fault_inject:
        from .core.supervision import parse_fault_inject
        try:
            parse_fault_inject(opts.fault_inject)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    # observability outputs are written at END of run: an unwritable
    # --trace/--metrics destination must fail now, not after the whole
    # simulation has been paid for.  Probe-open in append mode (no
    # truncation of an existing file) — catches a missing or read-only
    # directory, a path that IS a directory, and permission walls alike.
    for flag, path in (("--trace", opts.trace_path),
                       ("--metrics", opts.metrics_path)):
        if path:
            existed = os.path.exists(path)
            try:
                with open(path, "a"):
                    pass
            except OSError as e:
                print(f"error: {flag} {path!r} is not writable: {e}",
                      file=sys.stderr)
                return 2
            if not existed:
                # the probe must not leave a zero-byte artifact behind if
                # a LATER validation step rejects the invocation
                try:
                    os.unlink(path)
                except OSError:
                    pass
    if opts.test_mode:
        cfg = configuration.parse_xml(BUILTIN_TEST_CONFIG)
    elif opts.config_path:
        try:
            cfg = configuration.load(opts.config_path)
        except FileNotFoundError:
            print(f"error: config file not found: {opts.config_path}", file=sys.stderr)
            return 2
        except ValueError as e:
            print(f"error: bad config {opts.config_path}: {e}", file=sys.stderr)
            return 2
    else:
        print("error: provide a config file or --test", file=sys.stderr)
        return 2
    # an explicit --stop-time wins over the config; the config wins over the
    # Options default
    if opts.stop_time_explicit:
        cfg.stop_time_sec = opts.stop_time_sec
    elif not cfg.stop_time_sec:
        cfg.stop_time_sec = opts.stop_time_sec
    if opts.bootstrap_end_sec:
        cfg.bootstrap_end_sec = opts.bootstrap_end_sec
    opts.stop_time_sec = int(cfg.stop_time_sec)
    opts.bootstrap_end_sec = int(cfg.bootstrap_end_sec)
    return run_simulation(opts, cfg)


if __name__ == "__main__":
    sys.exit(main())
