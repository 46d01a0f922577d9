"""Finding/rule plumbing shared by every ``kao-check`` pass.

Counterpart of ``kafka_assignment_optimizer_tpu.analysis.findings``: the
same IDs (KAO100-KAO119, KAO201, KAO202) and the same suppression
grammar; a rule whose matcher looks for the PyTorch idiom of its hazard
carries a title in those terms (the README's port section holds the
table of matchers).

A finding is one (rule, file, line, message) tuple; rules are identified
by stable ``KAO1xx`` IDs (the README's port section is the catalog).
Suppression is inline and justified::

    print(out)  # kao: disable=KAO106 -- CLI stdout is the product

``# kao: disable=ID[,ID...]`` on the offending line (or the line above,
for lines that would overflow) silences those rules for that line; the
`` -- reason`` tail is the audit trail and is REQUIRED — a disable
without a justification does not suppress, it adds a KAO100 finding, so
the suppression inventory can never silently rot.

File-level suppression (generated code, vendored files) uses
``# kao: disable-file=ID -- reason`` within the first 20 lines.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# rule catalog: id -> (title, default severity). Kept here (not in the
# rule implementations) so --list-rules and docs render from one table.
RULES: dict[str, str] = {
    "KAO100": "suppression without justification",
    "KAO101": "sweep state read after a stepper consumed it",
    "KAO102": "state tensors from one expanded base, or an in-place "
              "write through an expanded view",
    "KAO103": "float64 in a device path",
    "KAO104": "PRNG key consumed twice without split/fold_in",
    "KAO105": "Python if/while/bool() on a tensor inside a factory's "
              "step (implicit host sync)",
    "KAO106": "bare print outside obs/log.py",
    "KAO107": "kao_* metric emitted without HELP/TYPE",
    "KAO108": "chaos/resilience hook inside a factory's step or a "
              "CUDA-graph capture",
    "KAO109": "per-partition Python for loop in a bound/reseat hot module",
    "KAO110": "lane-config value captured as a Python scalar in a "
              "solver factory",
    "KAO111": "serve/router outbound HTTP without causal-trace "
              "injection",
    "KAO112": "per-partition Python for loop in a decompose hot module",
    "KAO113": "host sync inside the chunk step or a CUDA-graph capture, "
              "or a device-wide synchronize outside the capture lock",
    "KAO114": "wall-clock delta outside the accounting funnel in a "
              "dispatch hot module",
    "KAO115": "stale device snapshot or implicit device in a mesh "
              "hot module",
    "KAO116": "guarded attribute mutated outside its lock",
    "KAO117": "blocking call while holding a lock",
    "KAO118": "lock-acquisition-order cycle (static deadlock "
              "candidate)",
    "KAO119": "thread started without join/daemon/lifecycle "
              "registration in a serving-plane module",
    "KAO201": "runtime contract violation (float64 or host sync in a "
              "solver step)",
    "KAO202": "state contract violation (round-trip, bucket shape, "
              "storage overlap)",
}

_DISABLE_RE = re.compile(
    r"#\s*kao:\s*(disable|disable-file)\s*=\s*"
    r"(?P<ids>KAO\d{3}(?:\s*,\s*KAO\d{3})*)"
    r"(?P<reason>\s*--\s*\S.*)?"
)


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class Suppressions:
    """Per-file suppression map parsed from the raw source text."""

    by_line: dict[int, set[str]] = field(default_factory=dict)
    whole_file: set[str] = field(default_factory=set)
    unjustified: list[int] = field(default_factory=list)

    def active(self, rule: str, line: int) -> bool:
        if rule in self.whole_file:
            return True
        ids = self.by_line.get(line)
        return bool(ids and rule in ids)


def parse_suppressions(text: str) -> Suppressions:
    sup = Suppressions()
    for lineno, raw in enumerate(text.splitlines(), start=1):
        m = _DISABLE_RE.search(raw)
        if not m:
            continue
        ids = {s.strip() for s in m.group("ids").split(",")}
        if not m.group("reason"):
            # a naked disable never suppresses — it is itself a finding
            sup.unjustified.append(lineno)
            continue
        if m.group(1) == "disable-file" and lineno <= 20:
            sup.whole_file |= ids
        elif raw.lstrip().startswith("#"):
            # a standalone comment line covers the line below it
            sup.by_line.setdefault(lineno + 1, set()).update(ids)
        else:
            # a trailing comment covers ONLY its own line — never the
            # next one, or a copy-pasted second violation under a
            # justified first would be silently suppressed
            sup.by_line.setdefault(lineno, set()).update(ids)
    return sup


def apply_suppressions(
    findings: list[Finding], path: str, sup: Suppressions
) -> list[Finding]:
    out = [
        f for f in findings if not sup.active(f.rule, f.line)
    ]
    out.extend(
        Finding("KAO100", path, ln,
                "kao: disable without a '-- reason' justification "
                "(unjustified suppressions do not suppress)")
        for ln in sup.unjustified
    )
    return out
