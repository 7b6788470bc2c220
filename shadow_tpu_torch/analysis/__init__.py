"""Static-analysis layer: lint-time proofs of the simulator's invariants.

The whole value of this engine is *deterministic* parallel discrete-event
simulation — every random stream derives from one master seed
(core/rng.py, mirroring the reference's utility/random.c + master.c:417),
simulation time is an integer nanosecond clock (core/stime.py), and the
digest-parity tests pin bit-identical state across every execution seam.
Those contracts are enforced dynamically by tests, but a test only checks
where it happens to look; one ``time.monotonic()`` on a sim path or one
read of a donated JAX buffer silently breaks reproducibility.

``simlint`` (python -m shadow_tpu_torch.analysis.simlint) proves the invariants
statically, codebase-wide, on every PR — see simlint.py for the engine and
rules.py for the rule catalog (SIM001-SIM006).

``simrace`` (python -m shadow_tpu_torch.analysis.simrace) reuses the same
engine, severity model, pragma and allowlist machinery for the
CONCURRENCY contracts, analyzing the package as a whole: lock identities
and lock-order edges, thread-shared state, blocking calls under locks
(race_rules.py, SIM101-SIM103) and the parent<->shard tag protocol
model-checked as a pair of communicating state machines (protocol.py,
SIM110).

Import ``shadow_tpu_torch.analysis.simlint`` / ``.simrace`` directly for the
APIs (lint_paths, lint_source, race_paths, race_sources); the package
module stays import-free so ``python -m`` execution of the submodules is
clean.
"""
