"""simfuzz: seeded scenario fuzzing for the engine's standing invariants.

Shadow's pitch is *varied real workloads* over a PDES core; this package
turns "scenario diversity" into a standing differential test instead of a
demo gallery (ROADMAP item 4).  From one integer seed it derives a
randomized-but-deterministic scenario — family (star/tor/cdn/swarm/phold/
app mix), host counts, bandwidth/latency/loss draws, optional generated
topology, plugin apps from ``apps/registry.py`` — plus a CLI-mode matrix
(device-vs-numpy twins, K=1-vs-K=8 superwindows, HostTable on/off,
serial/threaded/``--processes``, sharded mesh), runs the scenario short in
a bounded subprocess, and checks a pluggable oracle set: repeat-run digest
stability, cross-mode digest parity, event-count conservation,
``engine.supervision`` cleanliness, mesh invariants, and rc/log hygiene.

On a violation the scenario is SHRUNK (drop modes/apps/topology, halve
hosts/stoptime/bytes, re-verifying each step) to a minimal reproducer and
written as a self-contained repro file that ``simfuzz --repro PATH``
replays; failing seeds live in ``fuzz/corpus/`` as a regression set the
tier-1 suite replays.

Layout: gen.py (seed -> spec -> Configuration + mode matrix), runner.py
(in-process + bounded-subprocess execution), oracles.py (the invariant
set), shrink.py (minimizer), cli.py (``simfuzz`` console entry /
``python -m shadow_tpu_torch.fuzz``).
"""

SPEC_VERSION = 1
