"""genmark: the fenced-region marker grammar shared by simgen and SIM205.

A *generated region* is a span of a plane source file materialized from
the authoritative protocol spec (``spec/protocol_spec.json``) by
``simgen`` (`make gen`).  Each region is fenced by two marker lines:

    # >>> simgen:begin region=<name> spec=<sha12> body=<sha12>
    ... generated lines ...
    # <<< simgen:end region=<name>

(C files use ``//`` in place of ``#``.)  The ``spec=`` field is the
first 12 hex chars of the SHA-256 of the authoritative spec bytes at
generation time; ``body=`` is the same digest of the region body (the
lines strictly between the markers, including their newlines).  Both
tools — the generator's ``--check`` and the SIM205 lint rule — verify
the same two invariants from the same parse:

* ``body`` mismatch  -> the region was edited BY HAND after generation;
* ``spec`` mismatch  -> the spec changed after the region was emitted
  (the region is STALE; run ``make gen``).

The grammar lives here, below both simgen and twin_rules, so the two
verifiers can never drift on what a marker means.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

SPEC_RELPATH = "spec/protocol_spec.json"

BEGIN_RE = re.compile(
    r"^(?P<indent>\s*)(?P<lead>#|//)\s*>>> simgen:begin"
    r"\s+region=(?P<name>[A-Za-z0-9_.-]+)"
    r"\s+spec=(?P<spec>[0-9a-f]{12})"
    r"\s+body=(?P<body>[0-9a-f]{12})\s*$")
END_RE = re.compile(
    r"^(?P<indent>\s*)(?P<lead>#|//)\s*<<< simgen:end"
    r"\s+region=(?P<name>[A-Za-z0-9_.-]+)\s*$")
# anything that LOOKS like a marker but doesn't parse is a finding, not
# silence — a typo'd fence must not demote a region to "unguarded"
LOOSE_RE = re.compile(r"^\s*(#|//)\s*(>>>|<<<) simgen:")


def sha12(data) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return hashlib.sha256(data).hexdigest()[:12]


@dataclass
class Region:
    name: str
    lead: str            # "#" or "//"
    indent: str
    begin_line: int      # 1-based line of the begin marker
    end_line: int        # 1-based line of the end marker
    spec_hash: str
    body_hash: str
    body: str            # lines strictly between the markers


def begin_marker(name: str, lead: str, spec_hash: str, body_hash: str,
                 indent: str = "") -> str:
    return (f"{indent}{lead} >>> simgen:begin region={name} "
            f"spec={spec_hash} body={body_hash}")


def end_marker(name: str, lead: str, indent: str = "") -> str:
    return f"{indent}{lead} <<< simgen:end region={name}"


def scan_regions(text: str) -> Tuple[List[Region], List[Tuple[int, str]]]:
    """Parse every fenced region out of one source file.

    Returns (regions, problems) where each problem is (line, message):
    malformed marker lines, begin without end, end without begin, and
    mismatched region names on a begin/end pair.
    """
    regions: List[Region] = []
    problems: List[Tuple[int, str]] = []
    lines = text.splitlines()
    open_m: Optional[re.Match] = None
    open_line = 0
    body_lines: List[str] = []
    for i, line in enumerate(lines, start=1):
        b = BEGIN_RE.match(line)
        e = END_RE.match(line)
        if b is None and e is None:
            if LOOSE_RE.match(line):
                problems.append((i, "malformed simgen region marker — "
                                    "regenerate with `make gen`"))
            elif open_m is not None:
                body_lines.append(line)
            continue
        if b is not None:
            if open_m is not None:
                problems.append((open_line,
                                 f"simgen region "
                                 f"{open_m.group('name')!r} is never "
                                 f"closed before the next begin marker"))
            open_m, open_line, body_lines = b, i, []
            continue
        assert e is not None
        if open_m is None:
            problems.append((i, f"simgen end marker for region "
                                f"{e.group('name')!r} has no begin"))
            continue
        if e.group("name") != open_m.group("name"):
            problems.append((i, f"simgen end marker names region "
                                f"{e.group('name')!r} but the open region "
                                f"is {open_m.group('name')!r}"))
            open_m = None
            continue
        body = "".join(ln + "\n" for ln in body_lines)
        regions.append(Region(
            name=open_m.group("name"), lead=open_m.group("lead"),
            indent=open_m.group("indent"), begin_line=open_line,
            end_line=i, spec_hash=open_m.group("spec"),
            body_hash=open_m.group("body"), body=body))
        open_m = None
    if open_m is not None:
        problems.append((open_line,
                         f"simgen region {open_m.group('name')!r} is "
                         f"never closed"))
    return regions, problems
