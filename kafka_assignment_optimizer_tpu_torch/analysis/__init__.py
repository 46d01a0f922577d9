"""``kao-check`` over the port — static analysis, runtime contracts and
the runtime sanitizers, in PyTorch's idiom.

Counterpart of ``kafka_assignment_optimizer_tpu.analysis``, one CLI
(``python -m kafka_assignment_optimizer_tpu_torch.analysis``) with the
reference's flags, exit codes, formats and ratchet:

- :mod:`.rules_ast` and :mod:`.concurrency` — stdlib-``ast`` lint rules
  KAO100-KAO119 over this package's tree: the reference's
  language-general rules as they are, and its JAX-idiom rules translated
  to the port's hazards (stepper state reuse, expanded views, float64,
  PRNG key reuse, host syncs in the chunk step and under CUDA-graph
  capture, the device-wide synchronize beside a capture, frozen device
  lists). The README's port section holds the table.
- :mod:`.contracts` — KAO201/KAO202, the runtime contracts pass in place
  of the reference's jaxpr one: the real sweep and lane steppers and one
  eager chain round run once under a dispatch recorder on the demo
  instance's bucket shape.
- :mod:`.sanitize` — the runtime sanitizer (``KAO_SANITIZE=1``), and
  :mod:`.lsan` — the runtime lock sanitizer.

This package imports neither JAX nor the reference package.
"""

from __future__ import annotations

import os

from .findings import RULES, Finding  # noqa: F401
from .rules_ast import lint_source  # noqa: F401

_SKIP_DIRS = {"__pycache__", "_build", ".git"}


def package_root() -> str:
    """The port's own package directory: the default lint target, and
    the root that findings' paths are relative to."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def iter_py_files(root: str):
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d not in _SKIP_DIRS
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _rel(path: str, root: str) -> str:
    """``path`` relative to the package root, posix; a file outside the
    package keeps its own path, so no path-scoped rule matches a prefix
    like ``../<package>/`` by accident."""
    rel = os.path.relpath(path, root)
    if rel == os.pardir or rel.startswith(os.pardir + os.sep):
        rel = path
    return rel.replace(os.sep, "/")


def lint_paths(paths=None, rules=None) -> list[Finding]:
    """Run the AST pass over ``paths`` (default: the port's package
    tree). ``rules`` optionally restricts to a set of KAO IDs.

    Lock-order edges (KAO118) are additionally stitched ACROSS files
    here: per-file analysis sees each module's acquisition graph, but
    an inversion split between two modules only closes into a cycle on
    the union graph."""
    from .concurrency import cycle_findings
    from .findings import parse_suppressions
    from .rules_ast import lint_module

    root = package_root()
    findings: list[Finding] = []
    edges = []
    texts: dict[str, str] = {}
    for p in paths or [root]:
        for path in iter_py_files(p):
            with open(path, encoding="utf-8") as f:
                text = f.read()
            texts[path] = text
            found, file_edges = lint_module(text, path, rel=_rel(path, root))
            findings.extend(found)
            edges.extend(file_edges)
    seen = {(f.rule, f.path, f.line) for f in findings}
    for f in cycle_findings(edges):
        if (f.rule, f.path, f.line) in seen:
            continue  # intra-file copy already reported by lint_source
        sup = parse_suppressions(texts.get(f.path, ""))
        if not sup.active(f.rule, f.line):
            findings.append(f)
    if rules:
        findings = [f for f in findings if f.rule in rules]
    return findings
