"""Memory accounting for host boot (:mod:`.memprof`).  The HostTable tier
of the JAX package is not ported (see ROADMAP.md)."""
