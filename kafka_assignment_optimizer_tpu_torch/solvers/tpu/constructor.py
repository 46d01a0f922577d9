"""Constructor implementation switch for the greedy seed.

``seed.greedy_seed`` exists in two implementations: ``"vec"`` (the
vectorized default) and ``"legacy"`` (the per-partition original, the
parity oracle). ``KAO_CONSTRUCTOR`` selects one per process; an unknown
value selects ``"vec"``.
"""

from __future__ import annotations

import os

IMPLS = ("vec", "legacy")

_DEFAULT = os.environ.get("KAO_CONSTRUCTOR", "vec").strip().lower()
if _DEFAULT not in IMPLS:
    _DEFAULT = "vec"

_ACTIVE = _DEFAULT


def active() -> str:
    """The currently selected constructor implementation name."""
    return _ACTIVE

