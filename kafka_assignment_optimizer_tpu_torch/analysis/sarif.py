"""SARIF 2.1.0 rendering for ``kao-check --format sarif``.

Counterpart of ``kafka_assignment_optimizer_tpu.analysis.sarif``: the same
document for the same findings, over this package's rule catalog.

One run, one tool (``kao-check``), the full rule catalog under
``tool.driver.rules`` so viewers can render titles without a second
lookup. Findings tolerated by the baseline ratchet are still emitted —
with a ``suppressions`` entry of kind ``external`` — so code-scanning
UIs show them as accepted debt instead of dropping them; new findings
carry no suppression and surface as actionable.
"""

from __future__ import annotations

from .findings import RULES, Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/"
                "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")


def _result(f: Finding, *, baselined: bool) -> dict:
    res = {
        "ruleId": f.rule,
        "level": "error",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {
                    "uri": f.path,
                    "uriBaseId": "SRCROOT",
                },
                "region": {"startLine": max(f.line, 1)},
            },
        }],
    }
    if baselined:
        res["suppressions"] = [{
            "kind": "external",
            "justification": "accepted in analysis_baseline.json",
        }]
    return res


def render(findings: list[Finding],
           baselined: set[int] | None = None) -> dict:
    """``baselined`` holds indexes into ``findings`` whose entries are
    tolerated by the ratchet (empty/None = no baseline in play)."""
    baselined = baselined or set()
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "kao-check",
                    "informationUri":
                        "docs/ANALYSIS.md",
                    "rules": [
                        {
                            "id": rid,
                            "shortDescription": {"text": title},
                        }
                        for rid, title in sorted(RULES.items())
                    ],
                },
            },
            "results": [
                _result(f, baselined=i in baselined)
                for i, f in enumerate(findings)
            ],
        }],
    }
