"""Noise-aware bench-artifact comparator — the perf-regression gate.

A bench artifact is one JSON object of the bench driver's numbers. This
module diffs two artifacts and returns a structured verdict (a copy of
the reference package's ``obs.regress``; the artifact schema is the
same). Design constraints, in order:

**Environment gate first.** Latency numbers from different machines,
device counts, or PyTorch/CUDA builds are not comparable — a run on
another card or another torch build "regresses" without a line of code
changing. An artifact is stamped with git SHA, device count, platform
and the torch and CUDA versions; the comparator REFUSES to compare
artifacts whose platform/devices/torch/cuda differ (verdict
``incomparable``), instead of reporting a bogus regression. The git SHA
is informational — differing SHAs are the whole point.

**Ratio thresholds, never absolute deltas.** CHANGES.md documents
±60 % per-test wall-clock jitter on the build container, so "warm went
from 0.9 s to 1.3 s" means nothing in isolation. Latency checks
compare ``median(new_runs) / median(old_runs)`` (median-of-N where the
artifact carries run arrays — ``jumbo_cold_runs``,
``search_cold_runs`` — the scalar otherwise, which for warm numbers is
already a best-of-3):

- ratio > ``hard_ratio`` (default 2.5): **confirmed** on its own — no
  plausible jitter doubles-and-a-half a median;
- ``soft_ratio`` (default 1.6) < ratio <= hard: **suspect** — one
  suspect is jitter; a QUORUM of suspects (at least
  ``max(2, half the latency metrics checked)``) moving together is a
  real slowdown (independent jitter does not correlate across
  scenarios);
- throughput/speedup metrics (batch solves/s, ``pipeline_speedup``)
  invert the ratio (lower is worse).

**Quality is noise-free.** Feasibility, certification
(``proved_optimal``), move counts vs a tight lower bound, the
replay-day paired-quality verdict, and storm drops are deterministic
signals: any quality regression is confirmed regardless of ratios.

Verdict: ``regression`` iff any confirmed latency finding, a suspect
quorum, or any quality regression; an identical-artifact self-compare
is ``ok`` by construction (every ratio is 1.0).

``seed_slowdown(artifact, factor)`` builds the synthetic
slowed-by-``factor`` fixture CI uses to prove the gate actually trips
(soak.yml): every latency field multiplied, every throughput field
divided, quality untouched.

**Efficiency is its own axis.** The bench ``profile`` block
carries the roofline observatory's measured occupancy and ledger
shares (obs.prof); a >= 2x occupancy collapse or a > 0.25 absolute
device-share drop is confirmed on its own — walls can stay flat while
the same work quietly doubles its device windows.
``seed_occupancy_drop(artifact, factor)`` builds that gate's CI
trip-wire fixture (walls untouched, occupancy divided).

CLI: ``python -m kafka_assignment_optimizer_tpu_torch.obs.regress OLD NEW``
(exit 0 ok / 3 regression / 4 incomparable), or
``--seed-slowdown F IN OUT`` / ``--seed-occupancy-drop F IN OUT``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

__all__ = ["compare", "seed_slowdown", "seed_occupancy_drop",
           "load_artifact", "main"]

DEFAULT_SOFT_RATIO = 1.6
DEFAULT_HARD_RATIO = 2.5
# floor below which a latency sample is ignored entirely: at
# low-millisecond scale the ratio of two scheduler hiccups is pure
# noise (20 ms keeps the --smoke headline's best-of-3 warm number in
# play — the CI trip-wire needs at least two latency metrics)
MIN_MEANINGFUL_S = 0.02

ENV_KEYS = ("platform", "devices", "torch", "cuda")
# process-topology keys: compared only when BOTH
# artifacts carry the key — artifacts stamped before the topology
# fields existed must stay comparable against new ones — but a present
# mismatch (1-host vs 2-host, or a different chains×lanes mesh split)
# makes per-dispatch numbers incomparable, never a "regression"
TOPOLOGY_KEYS = ("n_processes", "mesh_axes")


def load_artifact(path: str) -> dict:
    """A bench artifact: the raw stdout-line JSON, or a driver wrapper
    whose ``parsed`` field holds it (``BENCH_r0*.json``)."""
    doc = json.loads(Path(path).read_text())
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a JSON object")
    if "metric" not in doc and isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    if "metric" not in doc:
        raise ValueError(
            f"{path}: not a bench artifact (no 'metric' field)"
        )
    return doc


def _median(xs) -> float | None:
    xs = [float(x) for x in xs if isinstance(x, (int, float))]
    if not xs:
        return None
    xs.sort()
    n = len(xs)
    mid = n // 2
    return xs[mid] if n % 2 else (xs[mid - 1] + xs[mid]) / 2.0


def _schema_fields(schema: str) -> list[str]:
    """Split a rows_schema string on top-level commas (the
    ``phase_s[bounds,...]`` group is ONE positional field)."""
    fields, cur, depth = [], "", 0
    for ch in schema:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        if ch == "," and depth == 0:
            fields.append(cur)
            cur = ""
        else:
            cur += ch
    if cur:
        fields.append(cur)
    return [f.split("[", 1)[0].strip() for f in fields]


def _rows_by_scenario(artifact: dict) -> dict[str, dict]:
    """Positional ``scenarios`` rows -> {scenario: {field: value}},
    driven by the artifact's OWN rows_schema (schemas grow across
    PRs; positions must never be hard-coded)."""
    schema = artifact.get("rows_schema")
    rows = artifact.get("scenarios")
    if not schema or not rows:
        return {}
    names = _schema_fields(schema)
    out = {}
    for row in rows:
        if not isinstance(row, list) or not row:
            continue
        d = {
            names[i]: row[i]
            for i in range(min(len(names), len(row)))
        }
        out[str(d.get("scenario"))] = d
    return out


def _env_verdict(old: dict, new: dict, force: bool) -> tuple[bool, str]:
    oe, ne = old.get("env"), new.get("env")
    if not isinstance(oe, dict) or not isinstance(ne, dict):
        if force:
            return True, "unstamped artifact(s); compared under --force"
        missing = [
            side for side, e in (("old", oe), ("new", ne))
            if not isinstance(e, dict)
        ]
        return False, (
            f"{'/'.join(missing)} artifact carries no env stamp "
            "(re-run the bench on a build that stamps git SHA / "
            "devices / torch / cuda, or pass --force)"
        )
    mismatches = [
        f"{k}: {oe.get(k)!r} != {ne.get(k)!r}"
        for k in ENV_KEYS if oe.get(k) != ne.get(k)
    ]
    mismatches += [
        f"{k}: {oe.get(k)!r} != {ne.get(k)!r}"
        for k in TOPOLOGY_KEYS
        if k in oe and k in ne and oe.get(k) != ne.get(k)
    ]
    if mismatches and not force:
        return False, (
            "environments are not comparable (" + "; ".join(mismatches)
            + ")"
        )
    return True, (
        "env mismatch overridden by --force: " + "; ".join(mismatches)
        if mismatches else "ok"
    )


def _latency_pairs(old: dict, new: dict) -> list[tuple[str, float, float]]:
    """Every comparable (name, old_seconds, new_seconds) latency
    metric present in BOTH artifacts. Lower is better for all."""
    pairs: list[tuple[str, float, float]] = []

    def add(name, ov, nv):
        # the noise floor gates on the LARGER side: tiny-vs-tiny is
        # scheduler noise, but a sub-floor baseline blowing up to
        # seconds (a broken warm-certify path) must stay visible
        if (isinstance(ov, (int, float)) and isinstance(nv, (int, float))
                and ov > 0 and max(float(ov), float(nv))
                >= MIN_MEANINGFUL_S):
            pairs.append((name, float(ov), float(nv)))

    orows, nrows = _rows_by_scenario(old), _rows_by_scenario(new)
    if not (orows and nrows):
        # headline-only artifacts (the CI smoke runs): the top-level
        # fields are the only numbers. With scenario rows present they
        # are the headline row's warm_s/cold_s VERBATIM — adding both
        # would count one jittery measurement as two correlated
        # "suspects" and defeat the independent-jitter quorum
        add("headline_warm_s", old.get("value"), new.get("value"))
        add("headline_cold_s", old.get("cold_wall_clock_s"),
            new.get("cold_wall_clock_s"))
    add("headline_cold_cached_s", old.get("cold_cached_wall_clock_s"),
        new.get("cold_cached_wall_clock_s"))
    for sc in sorted(set(orows) & set(nrows)):
        add(f"{sc}.warm_s", orows[sc].get("warm_s"),
            nrows[sc].get("warm_s"))
        add(f"{sc}.cold_s", orows[sc].get("cold_s"),
            nrows[sc].get("cold_s"))
    om, nm = _median(old.get("jumbo_cold_runs") or ()), \
        _median(new.get("jumbo_cold_runs") or ())
    add("jumbo_cold_median_s", om, nm)
    osc, nsc = old.get("search_cold_runs") or {}, \
        new.get("search_cold_runs") or {}
    for sc in sorted(set(osc) & set(nsc)):
        add(f"{sc}.cold_median_s", _median(osc[sc]), _median(nsc[sc]))
    ord_, nrd = old.get("replay_day") or {}, new.get("replay_day") or {}
    for k in ("warm_p50_s", "warm_p99_s", "cold_p50_s", "cold_p99_s"):
        add(f"replay_day.{k}", ord_.get(k), nrd.get(k))
    opa, npa = old.get("portfolio_ab") or {}, \
        new.get("portfolio_ab") or {}
    for k in ("ttfc_p50_s", "wall_p50_single_s",
              "wall_p50_portfolio_s"):
        add(f"portfolio_ab.{k}", opa.get(k), npa.get(k))
    oro, nro = old.get("rollout") or {}, new.get("rollout") or {}
    for k in ("pack_s", "replan_s", "total_s"):
        add(f"rollout.{k}", oro.get(k), nro.get(k))
    # decomposed rung (docs/DECOMPOSE.md): the ultra-jumbo cold wall is
    # the tentpole latency number — the decomposed-vs-flat speedup is
    # compared as a throughput ratio below, not double-counted here
    odc, ndc = old.get("decompose") or {}, new.get("decompose") or {}
    add("decompose.ultra_jumbo_cold_s", odc.get("ultra_jumbo_cold_s"),
        ndc.get("ultra_jumbo_cold_s"))
    # fleet latency: p99 ONLY — p50 and p99 of the same closed-loop
    # run move together, and two correlated draws must not fill the
    # suspect quorum as independent evidence (the same reasoning that
    # excludes the headline fields when scenario rows are present)
    ofl, nfl = old.get("fleet") or {}, new.get("fleet") or {}
    add("fleet.p99_s", ofl.get("p99_s"), nfl.get("p99_s"))
    # fused-megachunk arm (docs/PIPELINE.md): the fused warm wall ONLY
    # — wall_chunked_s is the adversarial warm_s already compared
    # above, and the speedup ratio is those two walls divided (quorum
    # honesty: one independent draw, counted once)
    oma, nma = old.get("megachunk_ab") or {}, \
        new.get("megachunk_ab") or {}
    add("megachunk_ab.wall_mega_s", oma.get("wall_mega_s"),
        nma.get("wall_mega_s"))
    return pairs


def _throughput_pairs(old: dict,
                      new: dict) -> list[tuple[str, float, float]]:
    """(name, old, new) where HIGHER is better."""
    pairs: list[tuple[str, float, float]] = []

    def add(name, ov, nv):
        if (isinstance(ov, (int, float)) and isinstance(nv, (int, float))
                and ov > 0):
            pairs.append((name, float(ov), float(nv)))

    obt, nbt = old.get("batch_throughput") or {}, \
        new.get("batch_throughput") or {}
    for k in ("b1", "b2", "b4", "b8"):
        add(f"batch.{k}_solves_per_s", obt.get(k), nbt.get(k))
    orows, nrows = _rows_by_scenario(old), _rows_by_scenario(new)
    for sc in sorted(set(orows) & set(nrows)):
        add(f"{sc}.pipeline_speedup",
            orows[sc].get("pipeline_speedup"),
            nrows[sc].get("pipeline_speedup"))
    # fleet capacity (docs/FLEET.md): aggregate solves/s through the
    # router. speedup is throughput/single_throughput — correlated
    # with it, so only one of the pair is compared (quorum honesty)
    ofl, nfl = old.get("fleet") or {}, new.get("fleet") or {}
    add("fleet.throughput", ofl.get("throughput"),
        nfl.get("throughput"))
    # decomposed-vs-flat speedup (docs/DECOMPOSE.md): higher means the
    # map-reduce rung buys more over the flat path at the A/B size
    odc, ndc = old.get("decompose") or {}, new.get("decompose") or {}
    add("decompose.speedup", odc.get("decompose_speedup"),
        ndc.get("decompose_speedup"))
    # ladder dispatch accounting (docs/PIPELINE.md): the
    # device share of the busy wall per scenario (higher = less host
    # round-trip overhead), and the fused arm's measured dispatch
    # amplification at K=8 (a counter ratio, not a wall clock — near
    # deterministic, so a drop is strong evidence). The fused wall
    # itself is a latency pair; megachunk_speedup is those two walls
    # divided and is NOT double-counted here.
    for sc in sorted(set(orows) & set(nrows)):
        add(f"{sc}.duty_cycle", orows[sc].get("duty_cycle"),
            nrows[sc].get("duty_cycle"))
    oma, nma = old.get("megachunk_ab") or {}, \
        new.get("megachunk_ab") or {}
    add("megachunk_ab.dispatch_reduction", oma.get("dispatch_reduction"),
        nma.get("dispatch_reduction"))
    # roofline occupancy (obs.prof): achieved/peak of the
    # dominant executable. Ratios between same-env artifacts are
    # meaningful even though the absolute peak is configurable; higher
    # is better. The ratio check here catches drift; a >= 2x collapse
    # is additionally CONFIRMED in _quality_regressions (the seeded
    # occupancy-halving fixture must trip without a quorum).
    opf, npf = old.get("profile") or {}, new.get("profile") or {}
    for k in ("occupancy_hbm", "occupancy_flops"):
        add(f"profile.{k}", opf.get(k), npf.get(k))
    # sharded-mesh A/B (docs/MESH.md): the best split's lane throughput
    # ONLY — lane_scaling is best/default divided, and the per-spec
    # curve points are correlated draws of the same run (quorum
    # honesty, same reasoning as megachunk_speedup). Topology mismatch
    # between artifacts is already an incomparability above.
    omb, nmb = old.get("mesh_bench") or {}, new.get("mesh_bench") or {}
    add("mesh_bench.best_lanes_per_s", omb.get("best_lanes_per_s"),
        nmb.get("best_lanes_per_s"))
    return pairs


# deterministic verdict keys per artifact block: their PRESENCE in both
# artifacts counts as a performed check (see compare() — an artifact
# whose only numbers sit under the latency noise floor, like the smoke
# rollout bench, is still genuinely compared on these), and their
# regression logic lives in _quality_regressions
_DETERMINISTIC_KEYS = (
    ("replay_day", ("quality_ok", "storm_dropped")),
    ("portfolio_ab", ("quality_win", "feasible_portfolio",
                      "worst_viol_portfolio")),
    ("batch_throughput", ("lanes_feasible", "moves_at_bound")),
    ("rollout", ("caps_ok", "terminal_ok")),
    ("fleet", ("affinity_ok", "quality_ok", "spread_ok", "dropped")),
    ("decompose", ("stitched_feasible", "gap_ok")),
    ("megachunk_ab", ("parity_ok", "feasible_mega")),
    ("profile", ("ledger_ok",)),
    ("mesh_bench", ("parity_ok",)),
)


def _quality_checks(old: dict, new: dict) -> int:
    """How many deterministic verdict keys are present in BOTH
    artifacts — the denominator that keeps a quality-only artifact
    from reading as 'nothing compared'."""
    n = 0
    for block, keys in _DETERMINISTIC_KEYS:
        ob, nb = old.get(block) or {}, new.get(block) or {}
        n += sum(1 for k in keys if k in ob and k in nb)
    return n


def _quality_regressions(old: dict, new: dict) -> list[dict]:
    regs: list[dict] = []
    orows, nrows = _rows_by_scenario(old), _rows_by_scenario(new)
    for sc in sorted(set(orows) & set(nrows)):
        o, n = orows[sc], nrows[sc]
        if o.get("feasible") == 1 and n.get("feasible") == 0:
            regs.append({"metric": f"{sc}.feasible",
                         "old": True, "new": False})
        if o.get("proved_optimal") == 1 and n.get("proved_optimal") == 0:
            regs.append({"metric": f"{sc}.proved_optimal",
                         "old": True, "new": False})
        lb = o.get("min_moves_lb")
        om, nm = o.get("moves"), n.get("moves")
        if (isinstance(lb, (int, float))
                and isinstance(om, (int, float))
                and isinstance(nm, (int, float))
                and om <= lb < nm):
            # the old build met a PROVABLY tight bound; the new one
            # does not — deterministic quality loss, not annealer luck
            regs.append({"metric": f"{sc}.moves_vs_bound",
                         "old": om, "new": nm, "bound": lb})
    ovb, nvb = old.get("vs_baseline"), new.get("vs_baseline")
    if (isinstance(ovb, (int, float)) and ovb > 0
            and isinstance(nvb, (int, float)) and nvb == 0):
        # vs_baseline is quality-gated to 0 on an infeasible/over-bound
        # headline plan — a zeroed score IS a quality regression
        regs.append({"metric": "headline.vs_baseline_zeroed",
                     "old": ovb, "new": nvb})
    ord_, nrd = old.get("replay_day") or {}, new.get("replay_day") or {}
    if ord_.get("quality_ok") is True and nrd.get("quality_ok") is False:
        regs.append({"metric": "replay_day.quality_ok",
                     "old": True, "new": False})
    if (ord_.get("storm_dropped") == 0
            and isinstance(nrd.get("storm_dropped"), (int, float))
            and nrd["storm_dropped"] > 0):
        regs.append({"metric": "replay_day.storm_dropped",
                     "old": 0, "new": nrd["storm_dropped"]})
    obt, nbt = old.get("batch_throughput") or {}, \
        new.get("batch_throughput") or {}
    for k in ("lanes_feasible", "moves_at_bound"):
        if obt.get(k) is True and nbt.get(k) is False:
            regs.append({"metric": f"batch.{k}",
                         "old": True, "new": False})
    # portfolio A/B quality (docs/PORTFOLIO.md): the worst-case-quality
    # win, the per-arm feasible counts, and the worst case's violation
    # count are all deterministic signals — any backslide is confirmed
    opa, npa = old.get("portfolio_ab") or {}, \
        new.get("portfolio_ab") or {}
    if opa.get("quality_win") is True and npa.get("quality_win") is False:
        regs.append({"metric": "portfolio_ab.quality_win",
                     "old": True, "new": False})
    of, nf = opa.get("feasible_portfolio"), npa.get("feasible_portfolio")
    if (isinstance(of, (int, float)) and isinstance(nf, (int, float))
            and nf < of):
        regs.append({"metric": "portfolio_ab.feasible_portfolio",
                     "old": of, "new": nf})
    ow, nw = opa.get("worst_viol_portfolio"), \
        npa.get("worst_viol_portfolio")
    if (isinstance(ow, (int, float)) and isinstance(nw, (int, float))
            and nw > ow):
        regs.append({"metric": "portfolio_ab.worst_viol_portfolio",
                     "old": ow, "new": nw})
    # streaming-rollout quality (docs/ROLLOUT.md): the cap contract and
    # the terminal verdict are deterministic — a wave exceeding its
    # transfer cap or a rollout failing to terminate cleanly is a
    # confirmed regression, never annealer luck
    oro, nro = old.get("rollout") or {}, new.get("rollout") or {}
    for k in ("caps_ok", "terminal_ok"):
        if oro.get(k) is True and nro.get(k) is False:
            regs.append({"metric": f"rollout.{k}",
                         "old": True, "new": False})
    # fleet-router quality (docs/FLEET.md): the affinity-rate floor,
    # the equal-quality verdict, the shared-cache spread proof, and
    # zero drops are all deterministic — a router that starts routing
    # cold, duplicating compiles, or dropping requests is a confirmed
    # regression regardless of wall-clock ratios
    ofl, nfl = old.get("fleet") or {}, new.get("fleet") or {}
    for k in ("affinity_ok", "quality_ok", "spread_ok"):
        if ofl.get(k) is True and nfl.get(k) is False:
            regs.append({"metric": f"fleet.{k}",
                         "old": True, "new": False})
    if (ofl.get("dropped") == 0
            and isinstance(nfl.get("dropped"), (int, float))
            and nfl["dropped"] > 0):
        regs.append({"metric": "fleet.dropped",
                     "old": 0, "new": nfl["dropped"]})
    # decomposed-rung quality (docs/DECOMPOSE.md): the oracle-checked
    # stitched feasibility and the certificate-or-gap verdict are
    # deterministic — a stitch that stops satisfying the ORIGINAL flat
    # instance, or a bound gap blowing past the tolerance, is a
    # confirmed regression, never annealer luck
    odc, ndc = old.get("decompose") or {}, new.get("decompose") or {}
    for k in ("stitched_feasible", "gap_ok"):
        if odc.get(k) is True and ndc.get(k) is False:
            regs.append({"metric": f"decompose.{k}",
                         "old": True, "new": False})
    # fused-megachunk quality (docs/PIPELINE.md): the fused
    # scan's bit-identical-plan parity and the fused plan's feasibility
    # are deterministic — a K=8 megachunk producing a different (or
    # infeasible) plan than the per-chunk ladder is a confirmed
    # trajectory break, never annealer luck. parity_ok is null when
    # the two arms walked different round counts (deadline noise);
    # null never trips the gate.
    oma, nma = old.get("megachunk_ab") or {}, \
        new.get("megachunk_ab") or {}
    for k in ("parity_ok", "feasible_mega"):
        if oma.get(k) is True and nma.get(k) is False:
            regs.append({"metric": f"megachunk_ab.{k}",
                         "old": True, "new": False})
    # efficiency regressions (obs.prof): occupancy collapsing
    # to half or worse is confirmed on its own — walls can stay flat
    # while the same work suddenly needs 2x the device windows (a
    # de-fused scan, a broken donation) and the latency quorum would
    # miss it. An attribution share shift (device share of wall falling
    # by > 0.25 absolute) is the same failure seen from the ledger
    # side. Tiny occupancies are excluded: below 1e-6 the ratio of two
    # measurement artifacts is noise, not evidence. The ledger
    # sums-to-wall conformance bit is deterministic like any parity.
    opf, npf = old.get("profile") or {}, new.get("profile") or {}
    for k in ("occupancy_hbm", "occupancy_flops"):
        ov, nv = opf.get(k), npf.get(k)
        if (isinstance(ov, (int, float)) and isinstance(nv, (int, float))
                and ov > 1e-6 and nv > 0 and ov / nv >= 2.0):
            regs.append({"metric": f"profile.{k}_collapse",
                         "old": ov, "new": nv,
                         "ratio": round(ov / nv, 3)})
    ods, nds = opf.get("device_share"), npf.get("device_share")
    if (isinstance(ods, (int, float)) and isinstance(nds, (int, float))
            and ods - nds > 0.25):
        regs.append({"metric": "profile.device_share_shift",
                     "old": ods, "new": nds})
    if opf.get("ledger_ok") is True and npf.get("ledger_ok") is False:
        regs.append({"metric": "profile.ledger_ok",
                     "old": True, "new": False})
    # sharded-mesh quality (docs/MESH.md): every candidate
    # (chains × lanes) split replaying the default split bit-for-bit
    # is the mesh's load-bearing contract — a parity flip means a
    # collective or placement change altered the trajectory, a
    # confirmed regression regardless of how the walls moved
    omm, nmm = old.get("mesh_bench") or {}, new.get("mesh_bench") or {}
    if omm.get("parity_ok") is True and nmm.get("parity_ok") is False:
        regs.append({"metric": "mesh_bench.parity_ok",
                     "old": True, "new": False})
    return regs


def compare(old: dict, new: dict, *,
            soft_ratio: float = DEFAULT_SOFT_RATIO,
            hard_ratio: float = DEFAULT_HARD_RATIO,
            force: bool = False) -> dict:
    """Diff two bench artifacts; returns the verdict dict (see module
    docstring for the noise model)."""
    comparable, reason = _env_verdict(old, new, force)
    base = {
        "gate": "kao-perf-regress",
        "thresholds": {"soft_ratio": soft_ratio,
                       "hard_ratio": hard_ratio},
        "env": {"old": old.get("env"), "new": new.get("env"),
                "note": reason},
    }
    if not comparable:
        return {**base, "comparable": False, "verdict": "incomparable",
                "reason": reason}
    # a bench run that failed outright emits an "error" artifact with
    # no real numbers — comparing it would read a broken bench as
    # "no regression"
    for side, art in (("old", old), ("new", new)):
        if art.get("error"):
            return {
                **base, "comparable": False,
                "verdict": "incomparable",
                "reason": (f"{side} artifact records a bench failure: "
                           f"{str(art['error'])[:200]}"),
            }

    confirmed, suspect, improved = [], [], []

    def judge(name, ratio, ov, nv):
        row = {"metric": name, "old": ov, "new": nv,
               "ratio": round(ratio, 3)}
        if ratio > hard_ratio:
            confirmed.append(row)
        elif ratio > soft_ratio:
            suspect.append(row)
        elif ratio < 1.0 / soft_ratio:
            improved.append(row)

    lat = _latency_pairs(old, new)
    for name, ov, nv in lat:
        judge(name, (nv / ov) if ov > 0 else 1.0, ov, nv)
    thr = _throughput_pairs(old, new)
    for name, ov, nv in thr:
        judge(name, (ov / nv) if nv > 0 else float("inf"), ov, nv)

    quality = _quality_regressions(old, new)
    n_checked = len(lat) + len(thr)
    n_quality = _quality_checks(old, new)
    if n_checked == 0 and n_quality == 0 and not quality:
        # nothing was comparable (disjoint scenario sets, stripped
        # artifacts): an empty check list must not read as a green
        # gate
        return {
            **base, "comparable": False, "verdict": "incomparable",
            "reason": "no comparable metrics between the artifacts",
        }
    quorum = max(2, -(-n_checked // 2))  # ceil(n/2), floor 2
    quorum_hit = len(suspect) + len(confirmed) >= quorum
    regression = bool(confirmed or quality) or quorum_hit
    return {
        **base,
        "comparable": True,
        "verdict": "regression" if regression else "ok",
        "checked": n_checked,
        "checked_quality": n_quality,
        "suspect_quorum": quorum,
        "latency": {
            "confirmed": confirmed,
            "suspect": suspect,
            "improved": improved,
        },
        "quality_regressions": quality,
        **({"reason": (
            "confirmed latency regression" if confirmed
            else "quality regression" if quality
            else f"{len(suspect)} correlated suspects >= quorum "
                 f"{quorum}"
        )} if regression else {}),
    }


def seed_slowdown(artifact: dict, factor: float) -> dict:
    """A synthetic copy of ``artifact`` slowed by ``factor``: every
    latency field multiplied, every throughput field divided, quality
    and the env stamp untouched. The CI gate's trip-wire fixture."""
    art = json.loads(json.dumps(artifact))
    f = float(factor)

    def scale(d, key, mul):
        v = d.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            d[key] = round(v * mul, 4)

    for k in ("value", "cold_wall_clock_s", "cold_cached_wall_clock_s"):
        scale(art, k, f)
    names = _schema_fields(art.get("rows_schema") or "")
    for row in art.get("scenarios") or ():
        if not isinstance(row, list):
            continue
        for field, mul in (("warm_s", f), ("cold_s", f),
                           ("compile_s", f)):
            if field in names:
                i = names.index(field)
                if i < len(row) and isinstance(row[i], (int, float)) \
                        and not isinstance(row[i], bool):
                    row[i] = round(row[i] * mul, 4)
    for k in ("jumbo_cold_runs",):
        if isinstance(art.get(k), list):
            art[k] = [round(x * f, 4) for x in art[k]]
    for sc, runs in (art.get("search_cold_runs") or {}).items():
        art["search_cold_runs"][sc] = [round(x * f, 4) for x in runs]
    rd = art.get("replay_day")
    if isinstance(rd, dict):
        for k in ("warm_p50_s", "warm_p99_s", "cold_p50_s",
                  "cold_p99_s"):
            scale(rd, k, f)
    bt = art.get("batch_throughput")
    if isinstance(bt, dict):
        for k in ("b1", "b2", "b4", "b8"):
            scale(bt, k, 1.0 / f)
    pa = art.get("portfolio_ab")
    if isinstance(pa, dict):
        for k in ("ttfc_p50_s", "wall_p50_single_s",
                  "wall_p50_portfolio_s"):
            scale(pa, k, f)
    fl = art.get("fleet")
    if isinstance(fl, dict):
        scale(fl, "p99_s", f)
        scale(fl, "throughput", 1.0 / f)
    dc = art.get("decompose")
    if isinstance(dc, dict):
        scale(dc, "ultra_jumbo_cold_s", f)
        scale(dc, "decompose_speedup", 1.0 / f)
    pf = art.get("profile")
    if isinstance(pf, dict):
        # a uniform slowdown stretches every device window, so the
        # achieved occupancy falls by the same factor (flops/window
        # against an unchanged peak)
        for k in ("occupancy_hbm", "occupancy_flops"):
            scale(pf, k, 1.0 / f)
    return art


def seed_occupancy_drop(artifact: dict, factor: float) -> dict:
    """A synthetic copy of ``artifact`` whose roofline occupancy
    collapsed by ``factor`` with every wall clock UNTOUCHED — the
    efficiency regression the latency quorum cannot see (the same work
    suddenly costing ``factor``x the device windows). CI's trip-wire
    fixture for the efficiency gate: ``factor`` >= 2 must
    trip exit 3 via the confirmed ``profile.*_collapse`` check."""
    art = json.loads(json.dumps(artifact))
    f = float(factor)
    pf = art.get("profile")
    if isinstance(pf, dict):
        for k in ("occupancy_hbm", "occupancy_flops",
                  "occupancy_hbm_p50", "occupancy_hbm_p99"):
            v = pf.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                pf[k] = round(v / f, 8)
        # the ledger view of the same collapse: device share of wall
        # shrinks toward zero as the lost time lands in other/gaps
        ds = pf.get("device_share")
        if isinstance(ds, (int, float)) and not isinstance(ds, bool):
            pf["device_share"] = round(ds / f, 4)
            shares = pf.get("ledger_shares")
            if isinstance(shares, dict):
                moved = ds - pf["device_share"]
                shares["device_s"] = round(
                    float(shares.get("device_s") or ds) / f, 4)
                shares["other_s"] = round(
                    float(shares.get("other_s") or 0.0) + moved, 4)
    return art


def run_compare(old_path: str, new_path: str, *,
                force: bool = False,
                soft_ratio: float = DEFAULT_SOFT_RATIO,
                hard_ratio: float = DEFAULT_HARD_RATIO) -> int:
    """Load, compare, print the verdict JSON FIRST (the CI contract:
    the verdict is replayable verbatim from the job log), return the
    gate's exit code: 0 ok / 3 regression / 4 incomparable."""
    try:
        old, new = load_artifact(old_path), load_artifact(new_path)
    except (OSError, ValueError) as e:
        # kao: disable=KAO106 -- the verdict JSON on stdout IS the product
        print(json.dumps({"gate": "kao-perf-regress",
                          "verdict": "error", "error": str(e)}))
        return 2
    verdict = compare(old, new, force=force, soft_ratio=soft_ratio,
                      hard_ratio=hard_ratio)
    # kao: disable=KAO106 -- the verdict JSON on stdout IS the product
    print(json.dumps(verdict, indent=2, default=str))
    if verdict["verdict"] == "incomparable":
        return 4
    return 3 if verdict["verdict"] == "regression" else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kafka_assignment_optimizer_tpu_torch.obs.regress",
        description="Noise-aware bench-artifact regression gate "
                    "(docs/OBSERVABILITY.md)",
    )
    ap.add_argument("old", nargs="?", help="baseline artifact JSON")
    ap.add_argument("new", nargs="?", help="candidate artifact JSON")
    ap.add_argument("--force", action="store_true",
                    help="compare despite missing/mismatched env stamps")
    ap.add_argument("--soft-ratio", type=float,
                    default=DEFAULT_SOFT_RATIO)
    ap.add_argument("--hard-ratio", type=float,
                    default=DEFAULT_HARD_RATIO)
    ap.add_argument("--seed-slowdown", type=float, metavar="FACTOR",
                    default=None,
                    help="instead of comparing: write a copy of OLD "
                         "slowed by FACTOR to NEW (the CI trip-wire "
                         "fixture)")
    ap.add_argument("--seed-occupancy-drop", type=float,
                    metavar="FACTOR", default=None,
                    help="instead of comparing: write a copy of OLD "
                         "whose roofline occupancy collapsed by FACTOR "
                         "(walls untouched) to NEW — the efficiency-"
                         "gate trip-wire fixture")
    args = ap.parse_args(argv)
    if args.old is None or args.new is None:
        ap.error("need OLD and NEW artifact paths")
    if args.seed_slowdown is not None:
        if args.seed_slowdown <= 0:
            ap.error("--seed-slowdown must be > 0")
        art = load_artifact(args.old)
        Path(args.new).write_text(
            json.dumps(seed_slowdown(art, args.seed_slowdown)) + "\n"
        )
        return 0
    if args.seed_occupancy_drop is not None:
        if args.seed_occupancy_drop <= 0:
            ap.error("--seed-occupancy-drop must be > 0")
        art = load_artifact(args.old)
        Path(args.new).write_text(
            json.dumps(seed_occupancy_drop(art, args.seed_occupancy_drop))
            + "\n"
        )
        return 0
    return run_compare(args.old, args.new, force=args.force,
                       soft_ratio=args.soft_ratio,
                       hard_ratio=args.hard_ratio)


if __name__ == "__main__":
    sys.exit(main())
