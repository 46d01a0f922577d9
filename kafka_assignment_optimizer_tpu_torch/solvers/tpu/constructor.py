"""Constructor implementation switch for the greedy seed.

``seed.greedy_seed`` exists in two implementations: ``"vec"`` (the
vectorized default) and ``"legacy"`` (the per-partition original, the
parity oracle). ``KAO_CONSTRUCTOR`` selects one per process; an unknown
value is logged as a warning and selects ``"vec"``.
"""

from __future__ import annotations

import logging
import os

IMPLS = ("vec", "legacy")

_DEFAULT = os.environ.get("KAO_CONSTRUCTOR", "vec").strip().lower()
if _DEFAULT not in IMPLS:
    # a typo'd override must not SILENTLY select an implementation the
    # operator did not ask for; say so, then run the default (raising
    # here would break every entry point on an environment typo)
    logging.getLogger(__name__).warning(
        "kao_constructor_invalid: value=%r expected=%s using=vec",
        os.environ.get("KAO_CONSTRUCTOR", ""), "|".join(IMPLS))
    _DEFAULT = "vec"

_ACTIVE = _DEFAULT


def active() -> str:
    """The currently selected constructor implementation name."""
    return _ACTIVE
