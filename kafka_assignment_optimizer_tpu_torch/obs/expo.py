"""Shared Prometheus text-exposition helpers.

Every surface that renders ``kao_*`` families — ``serve.py``'s
``/metrics``, the ``kao-fleet`` merger, the ``kao-router`` front
process — owes the same contract: one ``# HELP`` + ``# TYPE`` pair per
family (KAO107), legal names, quoted label values, and no duplicate
samples (``tests/test_metrics_format.validate_prometheus`` is the
arbiter). This module is the one implementation of that shape so new
surfaces cannot drift from it.

A *family* here is ``(name, kind, help_text, samples)`` where
``samples`` is a list of ``(labels, value)`` and ``labels`` is a dict
(or None for an unlabeled sample). Families with no samples still emit
their HELP/TYPE pair — pre-declaring a family at zero rows is how
dashboards see it before the first event.
"""

from __future__ import annotations

__all__ = ["family_lines", "render"]


def _label_str(labels: dict | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


def family_lines(name: str, kind: str, help_text: str,
                 samples: list) -> list[str]:
    """One family as exposition lines: HELP/TYPE pair, then every
    ``(labels, value)`` sample."""
    lines = [f"# HELP {name} {help_text}", f"# TYPE {name} {kind}"]
    for labels, value in samples:
        lines.append(f"{name}{_label_str(labels)} {value}")
    return lines


def render(families: list) -> str:
    """A full exposition body from ``(name, kind, help, samples)``
    tuples (trailing newline included, as the format requires)."""
    lines: list[str] = []
    for name, kind, help_text, samples in families:
        lines.extend(family_lines(name, kind, help_text, samples))
    return "\n".join(lines) + "\n"
