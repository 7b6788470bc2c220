"""How reliably torch.profiler keeps the card's events, over time.

    python -m shadow_tpu_torch.tools.trace_probe [--minutes 5] [--gap 20]

Repeats one short trace every ``--gap`` seconds for ``--minutes``: under
torch.profiler (CUDA activity only) it launches a marker kernel
(``torch.cuda._sleep``) at 0, 0.25, 0.5, 1, 1.5, 2 and 3 s into the trace,
each on an idle card, and prints one JSON line per trace: how many markers
the trace kept, and for each kept one the host's time of its launch minus
its time in the trace (the profiler's clock offset).  Needs a GPU; it is
the measurement behind chip_smoke.py's bracketed traces.
"""

from __future__ import annotations

import argparse
import json
import time as _walltime

DELAYS = (0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0)


def one_trace() -> dict:
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    launched = []
    with prof:
        t0 = _walltime.perf_counter()
        for d in DELAYS:
            while _walltime.perf_counter() - t0 < d:
                _walltime.sleep(0.01)  # simlint: disable=SIM005 -- spaces the probe's launches in wall time; no simulation runs here
            torch.cuda.synchronize()
            launched.append(_walltime.perf_counter() - t0)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        _walltime.sleep(0.2)  # simlint: disable=SIM005 -- keeps the profiler open past the last launch; no simulation runs here
    kept = sorted(e.time_range.start * 1e-6 for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "spin" in e.name)
    # a trace loses its earliest events, so the kept ones are the last
    offsets = [a - b for a, b in zip(launched[len(launched) - len(kept):],
                                     kept)]
    return {"kept": len(kept), "launched": len(DELAYS),
            "offset_s": offsets}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--gap", type=float, default=20.0,
                    help="seconds between traces")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("trace_probe needs a GPU")
    t_start = _walltime.monotonic()
    while _walltime.monotonic() - t_start < args.minutes * 60:
        row = one_trace()
        row["t_min"] = (_walltime.monotonic() - t_start) / 60
        print(json.dumps(row), flush=True)
        _walltime.sleep(args.gap)  # simlint: disable=SIM005 -- the wall-time gap between traces is the probe's parameter; no simulation runs here
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
