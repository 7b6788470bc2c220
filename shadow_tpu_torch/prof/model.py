"""The measured per-box cost model: schema, digest stamping, fingerprint
refusal, and the query surface the schedulers consult.

The port's copy of the JAX package's ``prof/model.py``.  A model is
produced by ``python -m shadow_tpu_torch.prof calibrate`` (calibrate.py),
which times the port's hand kernels, and carries three measurement tables:

* ``collectives`` — per-tick exchange cost in microseconds, keyed by
  ``"<kind>"`` -> ``"<D>x<width>"`` (kind in ppermute / all_to_all /
  psum).  On one card the D shards' exchange is part of csrc/mesh_span.cu,
  so the calibration fills these tables from differences of that kernel's
  tick between its exchange modes (calibrate.measure_collectives);
  :meth:`CostModel.exchange_tick_us` reads them as the JAX package reads
  its measured collectives;
* ``step_kernel`` — the span + pack step's cost per tick at measured flow
  counts (linear-fit for interpolation: ``us_per_step(a + b*flows)``);
* ``transfer`` — the plane's inject upload and flush read-back per launch,
  and the read-back's slope per MiB.

The model is **per box and per platform**: it carries a fingerprint (the
platform the measurement ran on, ``cuda`` or ``cpu``; the GPU's name and
compute capability on ``cuda``; the torch and CUDA versions; the host's
machine type, name and CPU count) and a sha256 digest over the whole
payload.  :func:`load_model` REFUSES a model whose schema, digest or
fingerprint does not match the run's platform on this box — a model made
on the CPU refuses on the card and the reverse, and the JAX package's
``COSTMODEL.json`` (fingerprinted to ``jax``) refuses by schema — and
:func:`load_for_engine` degrades that refusal into one warning line plus
the pre-model rules, never an exception.

Where a run looks for a model: ``--cost-model PATH``, else
``$SHADOW_TORCH_COSTMODEL``, else ``COSTMODEL_TORCH.json`` at the repo
root.  The port has a variable of its own because ``$SHADOW_COSTMODEL``
points the JAX package at an XLA model; the default never resolves to the
JAX package's ``COSTMODEL.json``.  Without a model the tuner keeps its
contract values (K from ``--superwindow-rounds``, cadence 8, no flush
caps) and the mesh its heuristic exchange, which are digest-neutral.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

# measured/predicted ratio band outside which a launch counts as
# model-stale evidence (prof.model_stale); wide because shared-tenant
# hosts swing, and because the measured span upper-bounds the kernel wall
DEFAULT_BAND = 6.0

_REQUIRED_KEYS = ("version", "fingerprint", "git_sha", "band",
                  "collectives", "step_kernel", "transfer", "digest")
_FINGERPRINT_KEYS = ("platform", "gpu", "capability", "machine", "node",
                     "cpus", "torch", "cuda")
_COLLECTIVE_KINDS = ("ppermute", "all_to_all", "psum")
PLATFORMS = ("cuda", "cpu")
ENV_PATH = "SHADOW_TORCH_COSTMODEL"


class CostModelError(Exception):
    """A model that must not be used: schema, digest, or fingerprint."""


def platform_of(device=None) -> str:
    """``cuda`` or ``cpu`` for a device name or ``torch.device`` (None:
    ``cuda``, the port's default device)."""
    name = "cuda" if device is None else str(
        getattr(device, "type", device)).split(":")[0]
    if name not in PLATFORMS:
        raise CostModelError(f"unknown platform {name!r} (choices: "
                             f"{', '.join(PLATFORMS)})")
    return name


def box_fingerprint(device=None) -> Dict:
    """The facts a measurement is only valid under, for runs on
    ``device`` (``cuda`` or ``cpu``; None: ``cuda``): the platform, the
    GPU's name and compute capability (None on ``cpu``), the torch and
    CUDA versions, and the host's machine type, name and CPU count.
    Raises :class:`CostModelError` for ``cuda`` on a machine with no card
    (never a CPU fingerprint in its place)."""
    import multiprocessing
    import platform

    import torch

    plat = platform_of(device)
    gpu = capability = None
    if plat == "cuda":
        if not torch.cuda.is_available():
            raise CostModelError(
                "platform 'cuda' but torch.cuda.is_available() is False")
        idx = getattr(device, "index", None)
        idx = torch.cuda.current_device() if idx is None else idx
        gpu = torch.cuda.get_device_name(idx)
        capability = "%d.%d" % torch.cuda.get_device_capability(idx)
    return {"platform": plat,
            "gpu": gpu,
            "capability": capability,
            "machine": platform.machine(),
            "node": platform.node(),
            "cpus": multiprocessing.cpu_count(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda}


def payload_digest(data: Dict) -> str:
    """sha256 over the canonical JSON of everything but the stamp itself
    — a hand-edited or truncated model fails the load, loudly."""
    body = {k: v for k, v in data.items() if k != "digest"}
    blob = json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def build_model(measurements: Dict, fingerprint: Optional[Dict] = None,
                git_sha: Optional[str] = None,
                wall_sec: Optional[float] = None,
                band: float = DEFAULT_BAND,
                truncated: bool = False, device=None) -> Dict:
    """Wrap raw calibration measurements into the stamped model dict
    (``fingerprint`` defaults to this box's for ``device``)."""
    if fingerprint is None:
        fingerprint = box_fingerprint(device)
    if git_sha is None:
        from .ledger import repo_git_sha
        git_sha = repo_git_sha() or "unknown"
    data = {
        "version": SCHEMA_VERSION,
        "fingerprint": fingerprint,
        "git_sha": git_sha,
        "wall_sec": round(wall_sec, 2) if wall_sec is not None else None,
        "band": float(band),
        "truncated": bool(truncated),
        "collectives": measurements.get("collectives", {}),
        "step_kernel": measurements.get("step_kernel", {"points": []}),
        "transfer": measurements.get("transfer", {}),
    }
    data["digest"] = payload_digest(data)
    return data


def validate_schema(data: Dict) -> List[str]:
    """Schema problems as strings (empty = valid).  Shared by load_model
    and ``simprof check``."""
    problems: List[str] = []
    for k in _REQUIRED_KEYS:
        if k not in data:
            problems.append(f"missing key {k!r}")
    if problems:
        return problems
    if data["version"] != SCHEMA_VERSION:
        problems.append(f"version {data['version']!r} != {SCHEMA_VERSION}")
    fp = data["fingerprint"]
    if not isinstance(fp, dict):
        problems.append("fingerprint is not a dict")
    else:
        for k in _FINGERPRINT_KEYS:
            if k not in fp:
                problems.append(f"fingerprint missing {k!r}")
    coll = data["collectives"]
    if not isinstance(coll, dict):
        problems.append("collectives is not a dict")
    else:
        for kind, table in coll.items():
            if kind not in _COLLECTIVE_KINDS:
                problems.append(f"unknown collective kind {kind!r}")
                continue
            for key, us in (table or {}).items():
                ok = isinstance(us, (int, float)) and us >= 0
                parts = str(key).split("x")
                ok = ok and len(parts) == 2 and all(
                    p.isdigit() for p in parts)
                if not ok:
                    problems.append(
                        f"collectives[{kind}][{key!r}] malformed")
    pts = (data["step_kernel"] or {}).get("points", [])
    if not isinstance(pts, list):
        problems.append("step_kernel.points is not a list")
    else:
        for p in pts:
            if not (isinstance(p, dict) and "flows" in p
                    and "us_per_step" in p):
                problems.append(f"step_kernel point malformed: {p!r}")
    tr = data["transfer"]
    if not isinstance(tr, dict):
        problems.append("transfer is not a dict")
    else:
        for k, v in tr.items():
            if not isinstance(v, (int, float)):
                problems.append(f"transfer[{k!r}] not numeric")
    if not (isinstance(data["band"], (int, float)) and data["band"] > 1):
        problems.append(f"band {data['band']!r} must be > 1")
    return problems


def save_model(path: str, data: Dict) -> None:
    """Atomic write (tmp + rename), stable key order, trailing newline."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load_model(path: str, fingerprint: Optional[Dict] = None,
               device=None) -> "CostModel":
    """Load + verify a model file.  Raises :class:`CostModelError` on a
    schema problem, a digest mismatch (tampered/corrupt payload), or a
    fingerprint mismatch against ``fingerprint`` (default: this box's for
    ``device``; None: ``cuda``) — a model calibrated on another box, on
    the other platform, or by the JAX package.  Refusal is the contract,
    fallback is the CALLER's job (:func:`load_for_engine`)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CostModelError(f"{path}: unreadable: {e}") from e
    if not isinstance(data, dict):
        raise CostModelError(f"{path}: invalid schema: not a JSON object")
    problems = validate_schema(data)
    if problems:
        raise CostModelError(f"{path}: invalid schema: "
                             + "; ".join(problems[:4]))
    if payload_digest(data) != data["digest"]:
        raise CostModelError(
            f"{path}: digest mismatch — the measurement table was edited "
            "or truncated after calibration (re-run simprof calibrate)")
    here = fingerprint if fingerprint is not None \
        else box_fingerprint(device)
    theirs = data["fingerprint"]
    drift = [k for k in _FINGERPRINT_KEYS if theirs.get(k) != here.get(k)]
    if drift:
        detail = ", ".join(
            f"{k}: {theirs.get(k)!r} != {here.get(k)!r}" for k in drift)
        raise CostModelError(
            f"{path}: fingerprint mismatch ({detail}) — this model was "
            "calibrated on a different box/platform; refusing to schedule "
            "from it (re-run simprof calibrate here)")
    return CostModel(data, path=path)


def default_model_path() -> str:
    """Resolution order: $SHADOW_TORCH_COSTMODEL, then the repo-root
    ``COSTMODEL_TORCH.json`` (never the JAX package's COSTMODEL.json)."""
    env = os.environ.get(ENV_PATH, "").strip()
    if env:
        return env
    from . import COSTMODEL_BASENAME, repo_root
    return os.path.join(repo_root(), COSTMODEL_BASENAME)


def load_for_engine(options) -> Tuple[Optional["CostModel"], str]:
    """The run-time entry point: resolve the model path from the options
    (``--cost-model``) or the default, load it for the run's device
    (``options.device``), and degrade every refusal into (None, status)
    with ONE loud log line — the consumers (mesh exchange decision,
    dispatch tuner, per-launch attribution) fall back to the pre-model
    rules, they never crash on a bad model file."""
    path = (getattr(options, "cost_model", "") or "").strip() \
        or default_model_path()
    if not os.path.exists(path):
        return None, "absent"
    from ..core.logger import get_logger
    try:
        return load_model(path, device=getattr(options, "device",
                                               "cuda")), "loaded"
    except CostModelError as e:
        get_logger().warning(
            "prof", f"cost model refused: {e} — falling back to the "
            "heuristic exchange schedule and skipping launch attribution")
        return None, "refused"


class CostModel:
    """Query surface over a verified model dict."""

    def __init__(self, data: Dict, path: Optional[str] = None):
        self.data = data
        self.path = path
        self.band = float(data.get("band") or DEFAULT_BAND)
        self.fingerprint = data["fingerprint"]
        self.git_sha = data.get("git_sha")
        # linear fit us_per_step ~= a + b * flows over the measured points
        pts = sorted(((int(p["flows"]), float(p["us_per_step"]))
                      for p in data["step_kernel"].get("points", [])))
        if len(pts) >= 2:
            xs = [p[0] for p in pts]
            ys = [p[1] for p in pts]
            n = len(pts)
            mx, my = sum(xs) / n, sum(ys) / n
            den = sum((x - mx) ** 2 for x in xs) or 1.0
            self._step_b = sum((x - mx) * (y - my)
                               for x, y in pts) / den
            self._step_a = my - self._step_b * mx
        elif pts:
            self._step_a, self._step_b = pts[0][1], 0.0
        else:
            self._step_a = self._step_b = 0.0
        # the smallest measured flow count: predictions BELOW (half) this
        # are extrapolations the model never measured — the device plane
        # skips launch attribution there rather than raise false stale
        # flags on toy tables (tests craft models with tiny points)
        self.min_flows = pts[0][0] if pts else 0
        # ... and the largest: predictions far ABOVE it are equally
        # unmeasured (a flagship-scale table judged by pure upward
        # extrapolation would mis-tune the dispatch loop the same way it
        # would mis-flag prof.model_stale)
        self.max_flows = pts[-1][0] if pts else 0

    # -- raw tables --------------------------------------------------------
    def collective_us(self, kind: str, n_dev: int, width: int) -> float:
        """Launch cost of one ``kind`` collective on a ``n_dev`` mesh at
        ``width`` total slots: exact key, else linear interpolation in
        width (clamped) within the nearest measured device count."""
        table = self.data["collectives"].get(kind) or {}
        if not table:
            return 0.0
        entries: Dict[int, Dict[int, float]] = {}
        for key, us in table.items():
            d_s, w_s = str(key).split("x")
            entries.setdefault(int(d_s), {})[int(w_s)] = float(us)
        d = min(entries, key=lambda k: abs(k - n_dev))
        widths = sorted(entries[d])
        w = max(min(width, widths[-1]), widths[0])
        lo = max(x for x in widths if x <= w)
        hi = min(x for x in widths if x >= w)
        if lo == hi:
            return entries[d][lo]
        frac = (w - lo) / (hi - lo)
        return entries[d][lo] + frac * (entries[d][hi] - entries[d][lo])

    def step_us(self, flows: int) -> float:
        """Step-kernel cost of ONE tick at ``flows`` table rows."""
        return max(self._step_a + self._step_b * max(int(flows), 0), 0.0)

    def covers(self, flows: int) -> bool:
        """True when ``flows`` sits inside the calibrated step-kernel
        range (with 2x slack each way) — the no-extrapolation guard both
        launch attribution AND the dispatch auto-tuner sit behind: a
        prediction outside the measured points is a guess, and guesses
        neither raise stale flags nor reshape the dispatch loop."""
        if not self.max_flows:
            return False
        f = int(flows)
        return f * 2 >= self.min_flows and f <= 2 * self.max_flows

    def transfer_us(self) -> float:
        tr = self.data["transfer"]
        return float(tr.get("dispatch_us", 0.0)) \
            + float(tr.get("flush_us", 0.0))

    def flush_us_per_mb(self) -> float:
        """Marginal flush readback cost per MiB of buffer (the measured
        size slope); 0.0 on a model that measured only one flush size —
        delta-compaction then has no measured savings to justify itself
        and stays off."""
        return float(self.data["transfer"].get("flush_us_per_mb", 0.0))

    def flush_savings_us(self, bytes_saved: int) -> float:
        """Predicted per-launch readback saving of shrinking the flush
        buffer by ``bytes_saved`` bytes."""
        return self.flush_us_per_mb() * max(int(bytes_saved), 0) / 2 ** 20

    # -- scheduler/attribution queries ------------------------------------
    def exchange_tick_us(self, n_dev: int, mode: str, pair_width: int,
                         leg_widths: List[int]) -> float:
        """Per-tick collective cost of one exchange mode: the fused
        all_to_all over the superposed [D, D*pair_width] slots, or one
        ppermute per rotation leg; both pay the fused stats psum the
        mesh kernel always issues."""
        psum = self.collective_us("psum", n_dev, 2)
        if mode == "fused":
            return psum + self.collective_us(
                "all_to_all", n_dev, n_dev * max(pair_width, 1))
        if mode == "ppermute":
            return psum + sum(
                self.collective_us("ppermute", n_dev, max(w, 1))
                for w in leg_widths)
        return psum if mode == "none" else 0.0

    def predict_window_us(self, steps: int, flows: int,
                          exchange_tick_us: float = 0.0) -> float:
        """Predicted device cost of one window launch: per-tick step
        kernel + per-tick exchange collectives, plus the fixed
        dispatch/flush transfer cost."""
        return max(int(steps), 0) * (self.step_us(flows)
                                     + max(exchange_tick_us, 0.0)) \
            + self.transfer_us()
