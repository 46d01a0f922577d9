"""Process-global decompose counters (a copy of
``kafka_assignment_optimizer_tpu.decompose.stats``): every view of the
decomposed solves reads one snapshot, so the views can never disagree.
"""

from __future__ import annotations

import threading

# counter names, every one present (at zero) in every snapshot
COUNTER_NAMES = (
    "solves",        # decomposed solves that returned a stitched plan
    "certified",     # ... with a global optimality certificate
    "gap_reported",  # ... that reported a bound gap instead
    "fallback",      # decompose_to_flat degradations (failed reduce)
    "unsplittable",  # instances the splitter declined (no structure)
    "subproblems",   # sub-instances solved across all map phases
    "iterations",    # map<->reduce iterations across all solves
)


class DecomposeStats:
    def __init__(self):
        self._lock = threading.Lock()
        self._c = {k: 0 for k in COUNTER_NAMES}
        self._last: dict = {}
        self._attempt: dict = {}

    def note_attempt(self, *, iteration: int, times: dict,
                     stitch_violations: int,
                     lane_violations: list[int]) -> None:
        """The latest map<->reduce iteration of the latest decomposed
        attempt, whether it then returned a plan or fell back to the flat
        path: its host-clock phase times (``map`` and ``reduce`` a list,
        one entry an iteration; ``certify``), the stitched plan's
        violations and each lane's best plan's. (This package's own
        addition: the reference keeps no record of a failed attempt.)"""
        with self._lock:
            self._attempt = {
                "iteration": int(iteration),
                "times": {k: list(v) if isinstance(v, list) else v
                          for k, v in times.items()},
                "stitch_violations": int(stitch_violations),
                "lane_violations": list(lane_violations),
            }

    def note_solve(self, *, subproblems: int, iterations: int,
                   certified: bool, bound_gap: int | None,
                   sub_shape: dict | None) -> None:
        with self._lock:
            self._c["solves"] += 1
            self._c["subproblems"] += int(subproblems)
            self._c["iterations"] += int(iterations)
            if certified:
                self._c["certified"] += 1
            else:
                self._c["gap_reported"] += 1
            self._last = {
                "subproblems": int(subproblems),
                "iterations": int(iterations),
                "certified": bool(certified),
                "bound_gap": 0 if certified else int(bound_gap or 0),
                "sub_shape": dict(sub_shape or {}),
            }

    def note_fallback(self, iterations: int = 0,
                      subproblems: int = 0) -> None:
        with self._lock:
            self._c["fallback"] += 1
            self._c["iterations"] += int(iterations)
            self._c["subproblems"] += int(subproblems)

    def note_unsplittable(self) -> None:
        with self._lock:
            self._c["unsplittable"] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"counters": dict(self._c), "last": dict(self._last),
                    "attempt": dict(self._attempt)}

    def reset(self) -> None:
        """Test isolation only."""
        with self._lock:
            self._c = {k: 0 for k in COUNTER_NAMES}
            self._last = {}
            self._attempt = {}


STATS = DecomposeStats()
