"""Ratchet baseline for the port's lint findings (the port of
``repro/analysis/baseline.py``; the file is
``src/repro_torch/analysis/lint_baseline.json``).

Pre-existing violations are *recorded*, not grandfathered forever: the
baseline stores each finding's line-number-free fingerprint
(``Finding.key()`` = rule :: path :: stripped source line) with a count,
so

  * a NEW violation (key absent, or count above baseline) fails CI;
  * FIXING a violation leaves a stale baseline entry, which also fails
    — with instructions to shrink the baseline (``--update``) — so the
    recorded debt only ever ratchets downward;
  * unrelated edits (line shifts, renames elsewhere) change nothing.

The file is committed JSON: sorted keys, counts, and a header noting
the ratchet contract, regenerated only via
``python -m repro_torch.analysis --update``.
"""
from __future__ import annotations

import collections
import json
import pathlib

__all__ = ["load_baseline", "save_baseline", "compare"]

_HEADER = ("ratcheted lint baseline: new findings fail CI; fixed "
           "findings must be removed via `python -m "
           "repro_torch.analysis --update`")


def _counts(findings) -> dict[str, int]:
    return dict(collections.Counter(f.key() for f in findings))


def load_baseline(path: "pathlib.Path | str") -> dict[str, int]:
    path = pathlib.Path(path)
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def save_baseline(path: "pathlib.Path | str", findings) -> int:
    """Write the baseline for ``findings``; returns the entry count."""
    counts = _counts(findings)
    payload = {"_comment": _HEADER,
               "findings": dict(sorted(counts.items()))}
    pathlib.Path(path).write_text(json.dumps(payload, indent=2) + "\n")
    return sum(counts.values())


def compare(findings, baseline: dict[str, int]):
    """(new, stale): ``new`` are current findings beyond the baselined
    count for their key (the ones that must be fixed); ``stale`` are
    baselined keys whose violations have (partly) disappeared, listed as
    ``(key, recorded, remaining)`` (the ratchet to shrink)."""
    current = _counts(findings)
    remaining = dict(baseline)
    new = []
    for f in sorted(findings, key=lambda x: (x.path, x.line, x.rule)):
        k = f.key()
        if remaining.get(k, 0) > 0:
            remaining[k] -= 1
        else:
            new.append(f)
    stale = [(k, baseline[k], current.get(k, 0))
             for k in sorted(baseline)
             if current.get(k, 0) < baseline[k]]
    return new, stale
