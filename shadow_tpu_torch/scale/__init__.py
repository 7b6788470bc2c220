"""Internet-scale tier (ROADMAP item 2): struct-of-arrays host state,
lazy host materialization, generated 100k-host scenarios, and memory
accounting.

* :mod:`.hosttable` — the HostTable: every configured host boots as a few
  numpy column entries; a full ``Host`` object exists only once the host
  actually needs plugin execution or a host-side event.
* :mod:`.genscen` — deterministic parameterized scenario generators
  (star100k, phold100k, tor100k) emitting ``Configuration`` objects
  directly instead of multi-megabyte XML strings.
* :mod:`.memprof` — bytes-per-host and peak-RSS accounting published
  through the metrics registry, so bench and CI gate memory the way they
  gate digests.
"""
