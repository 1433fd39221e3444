"""The guard that keeps ``BENCHMARK.json`` append-only.

It holds the accepted manifest by its digest: how many entries of each list
were accepted, and a digest of those entries, of ``command`` and of
``run_seconds``. Later changes add configurations, cells and metrics by
appending entries after the accepted ones, and may name a new cell in an
accepted metric's ``workloads``. An accepted entry is never moved, dropped
or changed, and keeps the accepted cells it lists, no more and no fewer (a
bound is never loosened).

The guard covers the manifest alone. The files that its entries name (a
cell's limits, traffic mix and configuration, the readers, the job kinds)
are not held here. Only a change that redefines the benchmark sets
``ACCEPTED`` anew, from ``python benchmark/accepted.py``, and says why in
``PERF.md``.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Dict, List

# list: (entries accepted, digest of them); "run": command and run_seconds
ACCEPTED = {
    "run": (0, "dab8f1bbbed260cf"),
    "configs": (2, "047abaf4b5fd70fb"),
    "workloads": (3, "5b8231b027fc066d"),
    "end_to_end": (4, "c366b34b435ba7cb"),
    "per_layer": (17, "d143c883b7b2f88d"),
}


def _digest(value) -> str:
    text = json.dumps(value, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def digests(manifest: dict) -> Dict[str, tuple]:
    """``ACCEPTED`` as ``manifest`` would set it: every entry of each list,
    each metric's ``workloads`` cut to the cells accepted."""
    n_cells = ACCEPTED["workloads"][0]
    cells = {w["name"] for w in manifest.get("workloads", [])[:n_cells]}
    out = {"run": (0, _digest([manifest.get("command"),
                               manifest.get("run_seconds")]))}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = []
        for e in manifest.get(kind, [])[:ACCEPTED[kind][0]]:
            if kind in ("end_to_end", "per_layer") and "workloads" in e:
                e = dict(e, workloads=[c for c in e["workloads"] if c in cells])
            entries.append(e)
        out[kind] = (len(entries), _digest(entries))
    return out


def departures(manifest: dict) -> List[str]:
    """How ``manifest`` departs from the accepted one; empty where it only
    appends."""
    bad = []
    for kind, got in digests(manifest).items():
        n, digest = ACCEPTED[kind]
        if kind == "run" and got != ACCEPTED[kind]:
            bad.append("command or run_seconds changed")
        elif got[0] < n:
            bad.append(f"{kind}: {got[0]} entries, {n} accepted")
        elif got[1] != digest:
            bad.append(f"{kind}: its first {n} entries moved or changed, or "
                       "an accepted metric's accepted cells changed")
    return bad


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cptbench import manifest as _manifest

    print(json.dumps(digests(_manifest.load())))
