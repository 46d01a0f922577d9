"""Findings-ratchet baseline for ``kao-check``.

Counterpart of ``kafka_assignment_optimizer_tpu.analysis.baseline``, the
same file format and the same ratchet. A baseline file (the port's
``analysis_baseline_torch.json``, committed) is the list of
findings the project has *accepted for now*. The ratchet is one-way:

- a finding **in** the baseline is tolerated (reported as suppressed in
  SARIF, omitted from the text failure set);
- a finding **not in** the baseline fails the gate — new debt never
  lands silently;
- a baseline entry with **no matching finding** ALSO fails the gate —
  when a finding is fixed, the entry must be removed (run
  ``--update-baseline``) so the baseline only ever shrinks and a stale
  entry can never mask a regression that happens to render the same.

Matching is by (rule, path, message) **multiset**, deliberately ignoring
the line number: unrelated edits above a tolerated finding must not
churn the baseline, but a *second* identical finding in the same file is
new debt and fails. Line numbers are still stored for human navigation.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from .findings import Finding

BASELINE_VERSION = 1


def fingerprint(f: Finding) -> tuple[str, str, str]:
    """Line-drift-tolerant identity of a finding."""
    return (f.rule, f.path, f.message)


@dataclass
class Ratchet:
    """Outcome of comparing current findings against a baseline."""

    known: list[Finding] = field(default_factory=list)
    new: list[Finding] = field(default_factory=list)
    # fixed-but-not-removed baseline entries, as parsed dicts
    stale: list[dict] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.new and not self.stale


def load(path: str) -> list[dict]:
    """Parse a baseline file into entry dicts. A missing file is an
    error (the gate must not silently run baseline-less): callers pass
    ``--baseline`` only when the file is expected to exist, and
    ``--update-baseline`` creates it."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "findings" not in doc:
        raise ValueError(f"{path}: not a kao-check baseline "
                         "(missing 'findings' key)")
    entries = doc["findings"]
    for e in entries:
        for k in ("rule", "path", "message"):
            if not isinstance(e.get(k), str):
                raise ValueError(
                    f"{path}: baseline entry missing '{k}': {e!r}")
    return entries


def save(path: str, findings: list[Finding]) -> None:
    doc = {
        "version": BASELINE_VERSION,
        "tool": "kao-check",
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message}
            for f in sorted(findings,
                            key=lambda f: (f.path, f.line, f.rule))
        ],
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def compare(findings: list[Finding], entries: list[dict]) -> Ratchet:
    """Split current findings into known/new and surface stale baseline
    entries, matching by fingerprint multiset."""
    budget: dict[tuple[str, str, str], int] = {}
    for e in entries:
        key = (e["rule"], e["path"], e["message"])
        budget[key] = budget.get(key, 0) + 1
    r = Ratchet()
    for f in findings:
        key = fingerprint(f)
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            r.known.append(f)
        else:
            r.new.append(f)
    for e in entries:
        key = (e["rule"], e["path"], e["message"])
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            r.stale.append(e)
    return r
