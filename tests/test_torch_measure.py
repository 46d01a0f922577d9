"""PyTorch port: the measurement plane against the JAX package's, on the
CPU — the scenario catalogue (``utils.gen.SCENARIOS``) scenario for
scenario, two catalogue solves plan for plan, the roofline profiler's
ledger aggregation, gap series and offline CLI, the analytic cost of a
chunk key worked out by hand, the regression gate's verdicts, the SLO
engine and the drift monitor fed one record stream, the Chrome export and
``trace_cli``, the device sampler's keys and tick budget, the
kernel-vs-torch bench without a card, and the CLI's ``--rf`` and
``--output`` (fault C9). Outputs are equal exactly."""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu import optimize as jax_optimize
from kafka_assignment_optimizer_tpu.cli import main as jcli
from kafka_assignment_optimizer_tpu.models.instance import (
    build_instance as jax_build,
)
from kafka_assignment_optimizer_tpu.obs import chrome as jchrome
from kafka_assignment_optimizer_tpu.obs import drift as jdrift
from kafka_assignment_optimizer_tpu.obs import prof as jprof
from kafka_assignment_optimizer_tpu.obs import regress as jregress
from kafka_assignment_optimizer_tpu.obs import sampler as jsampler
from kafka_assignment_optimizer_tpu.obs import slo as jslo
from kafka_assignment_optimizer_tpu.obs import trace_cli as jtrace_cli
from kafka_assignment_optimizer_tpu.ops import bench_kernel as jbench
from kafka_assignment_optimizer_tpu.ops.score import (
    score_batch as jax_score_batch,
)
from kafka_assignment_optimizer_tpu.solvers.tpu import arrays as jarrays
from kafka_assignment_optimizer_tpu.utils import gen as jgen
from kafka_assignment_optimizer_tpu_torch import optimize
from kafka_assignment_optimizer_tpu_torch.cli import main as tcli
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    demo_assignment,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.obs import (
    chrome,
    drift,
    flight,
    prof,
    regress,
    sampler,
    slo,
    trace_cli,
)
from kafka_assignment_optimizer_tpu_torch.ops import bench_kernel
from kafka_assignment_optimizer_tpu_torch.ops.score_cuda import (
    score_lanes_plain,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine, sweep
from kafka_assignment_optimizer_tpu_torch.utils import gen

from tests.test_torch_arrays import assert_same, fast_jit
from tests.test_torch_engine import port_cluster

PUBLISHED = ("decommission", "scale_out", "rf_change", "leader_only")


def assert_same_scenario(sj, st):
    assert st.name == sj.name
    assert st.current.to_json() == sj.current.to_json()
    assert st.broker_list == sj.broker_list
    assert st.topology.to_dict() == sj.topology.to_dict()
    assert (st.target_rf, st.min_moves_lb, st.lb_tight) == (
        sj.target_rf, sj.min_moves_lb, sj.lb_tight)


def test_catalogue_names_and_smoke_sizes_match_reference():
    assert list(gen.SCENARIOS) == list(jgen.SCENARIOS)
    assert len(gen.SCENARIOS) == 9
    assert gen.SMOKE_KWARGS == jgen.SMOKE_KWARGS


@pytest.mark.parametrize("name", list(jgen.SCENARIOS))
def test_scenario_at_smoke_size_matches_reference(name):
    assert_same_scenario(jgen.SCENARIOS[name](**jgen.SMOKE_KWARGS[name]),
                         gen.SCENARIOS[name](**gen.SMOKE_KWARGS[name]))


@pytest.mark.parametrize("name", PUBLISHED)
def test_scenario_at_published_size_matches_reference(name):
    assert_same_scenario(jgen.SCENARIOS[name](), gen.SCENARIOS[name]())


@pytest.mark.parametrize("name", ["leader_only", "rf_change"])
def test_catalogue_solve_matches_reference(name):
    """The tpu solver at its defaults on the smoke-size scenario (the
    in-place leader swaps of ``leader_only``, the ``target_rf`` of
    ``rf_change``): the same plan, moves and proof in both packages."""
    sc = jgen.SCENARIOS[name](**jgen.SMOKE_KWARGS[name])
    rj = jax_optimize(sc.current, sc.broker_list, sc.topology,
                      target_rf=sc.target_rf, solver="tpu", seed=0)
    current, brokers, topo = port_cluster(sc.current, sc.broker_list,
                                          sc.topology)
    rt = optimize(current, brokers, topo, target_rf=sc.target_rf,
                  solver="tpu", seed=0, device="cpu")
    assert rt.assignment.to_json() == rj.assignment.to_json()
    for f in ("replica_moves", "leader_changes", "objective_weight",
              "feasible", "proven_optimal", "solver_engine",
              "solver_construct_path"):
        assert rt.report().get(f) == rj.report().get(f), f
    assert rt.report()["replica_moves"] == sc.min_moves_lb


# --------------------------------------------------------------------------
# the roofline profiler
# --------------------------------------------------------------------------


def _ledger(wall, device, ok=True, **parts):
    led = {f: 0.0 for f in prof.LEDGER_FIELDS}
    led.update(device_s=device, **parts)
    led.update(wall_s=wall, ok=ok)
    return led


RECORDS = [
    {"ts": 1.0, "kind": "solve", "trace_id": "a", "bucket": [256, 4],
     "seq": 0, "ledger": _ledger(1.0, 0.5, constructor_s=0.2,
                                 other_s=0.3)},
    {"ts": 2.0, "kind": "lane", "trace_id": "b", "bucket": [256, 4],
     "seq": 1, "ledger": _ledger(2.0, 0.1, dispatch_gap_s=1.5,
                                 other_s=0.4)},
    {"ts": 3.0, "kind": "solve", "trace_id": "c", "bucket": [64, 3],
     "seq": 2, "ledger": _ledger(0.5, 0.0, ok=False, compile_s=0.6)},
    {"ts": 4.0, "kind": "delta", "trace_id": "d", "seq": 3},
    {"ts": 5.0, "kind": "solve", "trace_id": "e", "bucket": [64, 3],
     "seq": 4, "ledger": _ledger(3.0, 1.0, queue_wait_s=0.5,
                                 transfer_s=0.25, boundary_s=0.1)},
]


def test_ledger_attribution_matches_reference():
    assert prof.LEDGER_FIELDS == jprof.LEDGER_FIELDS
    assert (prof.attribution_summary(RECORDS)
            == jprof.attribution_summary(RECORDS))
    for n in (1, 3, 5):
        assert prof.worst_solves(RECORDS, n) == jprof.worst_solves(
            RECORDS, n)


def _drop_ts(rows):
    return [{k: v for k, v in r.items() if k != "ts"} for r in rows]


def test_observe_gaps_matches_reference():
    reports = [
        {"spans": {"name": "ladder", "start_s": 0.0, "wall_s": 1.0,
                   "spans": [
                       {"name": "dispatch", "start_s": 0.0, "wall_s": 0.1},
                       {"name": "chunk", "start_s": 0.1, "wall_s": 0.01},
                       {"name": "dispatch", "start_s": 0.103,
                        "wall_s": 0.1},
                       {"name": "dispatch", "start_s": 0.5, "wall_s": 0.2,
                        "spans": [{"name": "dispatch", "start_s": 0.55,
                                   "wall_s": 0.01}]}]}},
        {"spans": {"name": "solve_tpu", "start_s": 0.0, "wall_s": 2.0}},
        {"spans": None},
    ]
    for mod in (prof, jprof):
        mod.GAP_HIST.reset()
        for i, rep in enumerate(reports):
            mod.observe_gaps(rep, f"trace-{i}")
    assert prof.gap_snapshot() == jprof.gap_snapshot()
    assert _drop_ts(prof.gap_exemplars()) == _drop_ts(jprof.gap_exemplars())
    for mod in (prof, jprof):
        mod.GAP_HIST.reset()


@pytest.mark.parametrize("argv", [["--json"], ["--json", "--top", "2"],
                                  ["--kind", "solve"], []])
def test_prof_cli_over_flight_dir_matches_reference(tmp_path, capsys,
                                                    argv):
    rec = flight.FlightRecorder()
    rec.configure(str(tmp_path))
    for r in RECORDS:
        rec.write(dict(r))
    rec.configure(None)
    outs = []
    for mod in (jprof, prof):
        assert mod.main([str(tmp_path), *argv]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    for mod in (jprof, prof):
        assert mod.main([str(tmp_path / "missing")]) == 2
        assert "kao-prof" in capsys.readouterr().err


@pytest.fixture(scope="module")
def profiled_chunks():
    """One pinned sweep solve on the CPU (no race: the device path),
    with the profiler cleared first: its chunk key's row."""
    sc = gen.SCENARIOS["adversarial"](**gen.SMOKE_KWARGS["adversarial"])
    inst = build_instance(sc.current, sc.broker_list, sc.topology)
    prof.clear()
    res = engine.solve_tpu(inst, engine="sweep", batch=4, rounds=16,
                           portfolio=False, precompile=True, device="cpu",
                           cert_min_savings_s=float("inf"),
                           time_limit_s=3600.0)
    return inst, res, prof.snapshot()


def test_chunk_key_cost_model_worked_by_hand(profiled_chunks):
    """The analytic cost of a chunk key (one lane, N chains, a chunk of c
    sweeps) is the sum of its launches' costs, each written out here
    from the shapes: every input and output once, every gathered read
    counted up to its table's size (at most four weights a site
    proposal, two a partition of an exchange sweep), threefry at 71
    instructions a word."""
    inst, res, snap = profiled_chunks
    (row,) = snap["executables"]
    assert (row["path"], row["engine"], row["scorer"], row["chains"]) == (
        "single", "sweep", "torch", 4)
    assert snap["counters"]["captures_total"] == 1
    assert row["dispatches"] == snap["counters"]["reuses_total"] >= 2
    c = 16 // row["dispatches"]  # the sweeps of one chunk
    assert sweep.stage_counts(8) == {"B1 score": 2, "B2+B3 site sweep": 4,
                                     "B4+B5+B6 exchange sweep": 2}
    assert sweep.stage_counts(16) == {"B1 score": 3,
                                      "B2+B3 site sweep": 8,
                                      "B4+B5+B6 exchange sweep": 4}
    n_b1, n_site, n_ex = sweep.stage_counts(c).values()
    assert row["launches"] == sweep.stage_counts(c)

    N = 4
    P, R = row["bucket"]
    B1, K1 = inst.num_brokers + 1, inst.num_racks + 1
    valid = int(sum(min(p, R) for p in inst.rf))  # slots with a replica
    real = int(sum(1 for p in inst.rf if p > 0))  # rows with replicas
    a = N * P * R * 4
    i32 = 4
    b1_tables = P * R + P * i32 + B1 * i32 + 2 * K1 * i32
    b1_bytes = (a + b1_tables + i32 * min(N * (2 * valid - real),
                                          2 * P * B1)
                + N * (8 + 2 * B1 + K1) * i32)
    b1_ops = N * P * R * (12 + 2 * R)
    state = a + N * (2 * B1 + K1) * i32
    site_bytes = (2 * state + P * i32 + b1_tables
                  + i32 * min(N * real, P * R)
                  + i32 * min(4 * N * real, 2 * P * B1))
    site_ops = N * real * 7 * 71
    ex_bytes = (2 * (a + N * B1 * i32) + 2 * P * i32 + P * R + B1 * i32
                + i32 * min(2 * N * real, 2 * P * B1))
    ex_ops = (N * real + 2 * N) * 71
    assert row["bytes_accessed"] == (n_b1 * b1_bytes + n_site * site_bytes
                                     + n_ex * ex_bytes)
    assert row["flops"] == n_b1 * b1_ops + n_site * site_ops + n_ex * ex_ops
    assert row["peak_hbm_bytes"] is None  # the CPU: no card memory


def test_profiler_rows_roofline_and_overhead(profiled_chunks):
    """The key's row carries the reference's schema, pairs every device
    wait with a dispatch, and the profiler's own cost stays under 2% of
    the solve's wall (the reference's invariant)."""
    _inst, res, snap = profiled_chunks
    (row,) = snap["executables"]
    for k in ("key_id", "path", "sharding", "engine", "scorer", "devices",
              "chains", "bucket", "flops", "bytes_accessed",
              "peak_hbm_bytes", "compile_s", "dispatches", "device_s",
              "window_s", "occupancy_flops", "occupancy_hbm",
              "occupancy_hbm_p50", "occupancy_hbm_p99"):
        assert k in row, k
    assert snap["counters"]["unpaired_device_total"] == 0
    assert snap["peaks"]["platform"] == "cpu"
    assert prof.roofline()[0]["bucket"] == row["bucket"]
    assert prof.overhead()["seconds_total"] < 0.02 * res.wall_clock_s


def test_profile_dir_writes_a_trace_and_keeps_the_plan(tmp_path):
    """``solve_tpu(profile_dir=...)`` writes a torch.profiler trace of
    the ladder there and returns the unprofiled solve's plan."""
    sc = gen.SCENARIOS["adversarial"](**gen.SMOKE_KWARGS["adversarial"])
    kw = dict(engine="sweep", batch=2, rounds=8, portfolio=False,
              precompile=True, device="cpu",
              cert_min_savings_s=float("inf"))
    inst = build_instance(sc.current, sc.broker_list, sc.topology)
    ref = engine.solve_tpu(inst, **kw)
    got = engine.solve_tpu(inst, profile_dir=str(tmp_path / "p"), **kw)
    np.testing.assert_array_equal(got.a, ref.a)
    files = list((tmp_path / "p").glob("*.pt.trace.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]


# --------------------------------------------------------------------------
# the regression gate, the SLO engine, the drift monitor
# --------------------------------------------------------------------------


def _prof_artifact() -> dict:
    """``tests/test_prof.py``'s synthetic bench artifact."""
    return {
        "metric": "decommission_255b_10000p_warm_wall_clock",
        "value": 1.0, "unit": "s",
        "platform": "cpu", "cold_wall_clock_s": 2.0,
        "moves": 117, "min_moves_lb": 117, "feasible": True,
        "proved_optimal": True,
        "env": {"git_sha": "aaaa000000", "platform": "cpu",
                "devices": 8, "xla_flags": ""},
        "profile": {
            "path": "lanes", "flops": 2.5e9, "bytes_accessed": 1.0e9,
            "occupancy_flops": 0.04, "occupancy_hbm": 0.15,
            "occupancy_hbm_p50": 0.14, "occupancy_hbm_p99": 0.18,
            "dispatches": 64, "device_s": 0.5, "device_share": 0.5,
            "ledger_shares": {"device_s": 0.5, "other_s": 0.1},
            "ledger_ok": True,
        },
    }


def test_regress_verdicts_match_reference():
    art = _prof_artifact()
    bad = json.loads(json.dumps(art))
    bad["profile"]["ledger_ok"] = False
    for mod in (regress, jregress):
        assert mod.seed_slowdown(art, 2.0) == jregress.seed_slowdown(art, 2.0)
        assert (mod.seed_occupancy_drop(art, 2.0)
                == jregress.seed_occupancy_drop(art, 2.0))
    for new in (json.loads(json.dumps(art)), jregress.seed_slowdown(art, 2.0),
                jregress.seed_occupancy_drop(art, 2.0), bad):
        assert regress.compare(art, new) == jregress.compare(art, new)
    v = regress.compare(art, jregress.seed_occupancy_drop(art, 2.0))
    assert v["verdict"] == "regression"
    # the env gate: another torch or CUDA build is not comparable
    other = json.loads(json.dumps(art))
    other["env"]["torch"] = "2.11.0+cu128"
    assert regress.compare(art, other)["verdict"] == "incomparable"
    assert regress.ENV_KEYS == ("platform", "devices", "torch", "cuda")


def _stream(n_stable=40, n_slow=40):
    """A seeded record stream: ``n_stable`` solves around 1 s, then
    ``n_slow`` at ten times that, some infeasible, and delta records."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(n_stable + n_slow):
        wall = float(rng.uniform(0.8, 1.2)) * (10.0 if i >= n_stable else 1)
        out.append({"ts": 1000.0 + i, "kind": "solve" if i % 5 else "delta",
                    "wall_s": round(wall, 4), "trace_id": f"t{i}",
                    "quality": {"feasible": i % 17 != 3,
                                "certified": i % 3 != 0}})
    return out


def test_slo_engine_matches_reference():
    spec = "solve:5:0.99,delta:2:0.995"
    engines = (slo.SLOEngine(), jslo.SLOEngine())
    for e in engines:
        e.configure(spec=spec)
        for rec in _stream():
            e.observe_record(rec)
    assert engines[0].snapshot(now=1100.0) == engines[1].snapshot(now=1100.0)
    assert slo.parse_spec(spec) == jslo.parse_spec(spec)
    for bad in ("solve", "solve:x", "solve:5:2"):
        with pytest.raises(ValueError):
            slo.parse_spec(bad)
        with pytest.raises(ValueError):
            jslo.parse_spec(bad)


def test_drift_monitor_matches_reference():
    monitors = (drift.DriftMonitor(quiet=True), jdrift.DriftMonitor(quiet=True))
    tripped = [[m.observe_record(r) for r in _stream()] for m in monitors]
    assert tripped[0] == tripped[1]
    assert any("p99" in t for t in tripped[0])
    snaps = [m.snapshot() for m in monitors]

    def scrub(x):
        if isinstance(x, dict):
            return {k: scrub(v) for k, v in x.items() if k != "ts"}
        if isinstance(x, list):
            return [scrub(v) for v in x]
        return x

    assert scrub(snaps[0]) == scrub(snaps[1])
    assert (drift.render_families(monitors[0].metric_rows())
            == jdrift.render_families(monitors[1].metric_rows()))


# --------------------------------------------------------------------------
# the Chrome export and trace_cli
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def solve_report():
    """A traced pinned sweep solve's span report (the port, on the CPU)."""
    sc = gen.SCENARIOS["adversarial"](**gen.SMOKE_KWARGS["adversarial"])
    inst = build_instance(sc.current, sc.broker_list, sc.topology)
    res = engine.solve_tpu(inst, engine="sweep", batch=2, rounds=8,
                           portfolio=False, device="cpu", trace=True)
    return res.stats["solve_report"]


def test_chrome_export_matches_reference(solve_report):
    assert chrome.to_chrome(solve_report) == jchrome.to_chrome(solve_report)
    assert (chrome.report_to_json(solve_report, indent=1)
            == jchrome.report_to_json(solve_report, indent=1))


def test_trace_cli_convert_and_flight_match_reference(solve_report,
                                                      tmp_path, capsys):
    src = tmp_path / "report.json"
    src.write_text(json.dumps({"solve_report": solve_report}))
    outs = []
    for i, mod in enumerate((jtrace_cli, trace_cli)):
        out = tmp_path / f"chrome{i}.json"
        assert mod.main(["convert", str(src), "-o", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    rec = flight.FlightRecorder()
    rec.configure(str(tmp_path / "fl"))
    for r in RECORDS:
        rec.write(dict(r))
    rec.configure(None)
    for argv in (["flight", str(tmp_path / "fl")],
                 ["flight", str(tmp_path / "fl"), "--kind", "solve",
                  "--tail", "2"],
                 ["flight", str(tmp_path / "nope")]):
        got = []
        for mod in (jtrace_cli, trace_cli):
            rc = mod.main(argv)
            got.append((rc, capsys.readouterr().out))
        assert got[0] == got[1], argv


# --------------------------------------------------------------------------
# the device sampler
# --------------------------------------------------------------------------


def test_sampler_keys_budget_and_duty_cycle(monkeypatch):
    """With the card's reads stubbed on the CPU, an armed sampler's
    ``stats()``/``snapshot()`` carry the reference's keys, the stubbed
    devices, a duty cycle derived from the flight accumulator, and a
    per-tick cost under the reference's pinned budget (10 ms a tick is
    1% at 1 Hz)."""
    devs = {"gpu:0": {"bytes_in_use": 7, "bytes_reserved": 8,
                      "bytes_limit": 9}}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(sampler, "_card_totals", lambda _t: [9])
    monkeypatch.setattr(sampler, "_read_devices", lambda _t, _n: devs)
    s = sampler.DeviceSampler()
    s.configure(50.0)
    try:
        deadline = time.time() + 10
        while s.snapshot()["samples_total"] < 5 and time.time() < deadline:
            time.sleep(0.05)
        flight.record({
            "ts": time.time(), "kind": "solve", "wall_s": 2.0,
            "split": {"compile_s": 0.0, "device_s": 1.5,
                      "dispatch_s": 0.1, "host_s": 0.4},
            "quality": {"feasible": True, "certified": True},
        })
        deadline = time.time() + 10
        while s.snapshot()["duty_cycle"] == 0.0 and time.time() < deadline:
            time.sleep(0.05)
        snap, stats = s.snapshot(), s.stats()
    finally:
        s.stop()
    ref = jsampler.DeviceSampler()
    assert set(snap) == set(ref.snapshot())
    assert set(stats) == set(ref.stats())
    assert snap["devices"] == stats["devices"] == devs
    assert snap["enabled"] == 1 and snap["hz"] == 50.0
    assert snap["samples_total"] >= 5
    assert snap["avg_sample_s"] < 0.010, snap
    assert 0.0 < snap["duty_cycle"] <= 1.0
    assert any(row["device_frac"] > 0 for row in snap["roofline"].values())
    assert sampler.SAMPLER.snapshot()["enabled"] == 0


def test_sampler_reads_no_device_on_the_cpu():
    """Unarmed on the CPU a tick reads no device; the per-card read is the
    allocator's counters beside each card's total."""
    s = sampler.DeviceSampler()
    s._tick()
    assert s.stats()["devices"] == {} and s.stats()["samples_total"] == 1

    class Cuda:  # the two allocator counters of a two-card host
        memory_allocated = staticmethod(lambda i: 10 + i)
        memory_reserved = staticmethod(lambda i: 20 + i)

    class Torch:
        cuda = Cuda

    assert sampler._read_devices(Torch, [90, 91]) == {
        "gpu:0": {"bytes_in_use": 10, "bytes_reserved": 20,
                  "bytes_limit": 90},
        "gpu:1": {"bytes_in_use": 11, "bytes_reserved": 21,
                  "bytes_limit": 91}}


# --------------------------------------------------------------------------
# kernel_vs_torch without a card; the CLI's --rf and --output (C9)
# --------------------------------------------------------------------------


def test_kernel_vs_torch_on_the_cpu_reports_plain_rows():
    """Without a card the bench reports the plain versions only and says
    why, as the reference's ``kernel_vs_xla`` does off the TPU; its
    instance is the reference's, and B1's plain version scores its
    chains as the reference's XLA scorer does."""
    rep = bench_kernel.kernel_vs_torch(smoke=True, device="cpu")
    jrep = jbench.kernel_vs_xla(smoke=True, n=4)
    assert rep["skipped"] and jrep["skipped"]
    assert (rep["partitions"], rep["brokers"]) == (jrep["partitions"],
                                                   jrep["brokers"])
    rows = rep["rows"]
    assert [(r["name"], r["lanes"]) for r in rows] == [
        (k, L) for L in (1, 8)
        for k in ("B1 score", "B2+B3 site sweep",
                  "B4+B5+B6 exchange sweep")]
    for r in rows:
        assert r["plain_ms"] > 0 and r["bytes"] > 0 and r["int_ops"] > 0
        assert "ms" not in r and "parity" not in r
    _sc, inst, m, _seed, a = bench_kernel.population("cpu", smoke=True)
    sc = jgen.SCENARIOS["decommission"](**jgen.SMOKE_KWARGS["decommission"])
    jinst = jax_build(sc.current, sc.broker_list, sc.topology)
    mj = jarrays.from_instance(jinst, num_parts=m.num_parts,
                               max_rf=m.max_rf)
    ref = fast_jit(jax_score_batch)(jnp.asarray(a.numpy()), mj)
    out = score_lanes_plain(bench_kernel._lanes(m, a, 1)[0], a[None])[0][0]
    assert_same(ref.weight, out[:, 0], "weight")
    assert_same(np.stack([ref.pen_broker, ref.pen_leader, ref.pen_rack,
                          ref.pen_part_rack], 1), out[:, 1:5], "penalties")
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(RuntimeError):
            bench_kernel.kernel_vs_torch(smoke=True)


def test_bound_counts_distinct_entries_and_the_estimate_covers_it():
    """The bound (``bench_kernel.data_cost``, on a launch's own inputs)
    charges a gathered entry once per distinct entry: the eight lanes of
    the bench roll one population's chains over shared tables, so they
    read the one lane's weight entries and B1's bytes grow only by each
    lane's chains and outputs. The profiler's shape estimate
    (``launch_cost``) is at least the bound in every launch."""
    _sc, _inst, m, _seed, a = bench_kernel.population("cpu", smoke=True)
    b1 = {}
    for L in (1, 8):
        ms, al, keys, temps = bench_kernel._lanes(m, a, L)
        outs = score_lanes_plain(ms, al)
        shape = bench_kernel.dispatch_shape(ms, a.shape[0])
        for k in (bench_kernel.SCORE, bench_kernel.SITE,
                  bench_kernel.EXCHANGE):
            cost = bench_kernel.data_cost(k, ms, al, outs[1:], keys, temps)
            est = bench_kernel.launch_cost(k, shape)
            assert 0 < cost["bytes"] <= est["bytes"], (k, L, cost, est)
            assert cost["int_ops"] >= est["int_ops"] > 0, (k, L)
        b1[L] = bench_kernel.data_cost(bench_kernel.SCORE, ms, al, outs[1:],
                                       keys, temps)["bytes"]
        if L == 1:
            stream = bench_kernel.nbytes(al, *outs)
    assert b1[8] - b1[1] == 7 * stream
    b = torch.tensor([[0, 1, 1], [2, 1, 0]])
    one = bench_kernel.gathered(4, (0, b, True, 0))
    assert one == 4 * 5  # (p, b): (0,0) (1,1) (2,1) (0,2) (2,0)
    assert bench_kernel.gathered(4, (0, b, True, 0), (0, b, True, 0)) == one
    assert bench_kernel.gathered(4, (0, b, True, 0), (0, b, True, 1)) \
        == 2 * one
    assert bench_kernel.gathered(4, (0, b, True, 0), (1, b, True, 0)) \
        == 2 * one


def test_cli_rf_change_and_output_file_match_reference(tmp_path, capsys):
    """Fault C9: the README demo with ``--rf 3 -o FILE`` through both
    CLIs in process: both exit 0 and write byte-equal plans; ``--rf`` as
    a topic map and an unparsable ``--rf`` behave alike too."""
    cur = tmp_path / "cur.json"
    cur.write_text(demo_assignment().to_json())
    base = ["-i", str(cur), "--broker-list", "0-18", "--topology",
            "even-odd"]
    cases = (["--rf", "3"], ["--rf", '{"t1": 3}'], ["--rf", "three"])
    for extra in cases:
        got = []
        for i, (main, dev) in enumerate(((jcli, []),
                                         (tcli, ["--device", "cpu"]))):
            out = tmp_path / f"plan{i}.json"
            out.unlink(missing_ok=True)
            rc = main([*base, *extra, "-o", str(out), *dev])
            err = capsys.readouterr()
            assert err.out == ""
            got.append((rc, out.read_bytes() if out.exists() else None))
        assert got[1] == got[0], extra
    assert got[0][0] == 2  # the unparsable --rf
    rc = tcli([*base, "--rf", "3", "-o", str(tmp_path / "p.json"),
               "--device", "cpu"])
    plan = json.loads((tmp_path / "p.json").read_text())
    assert rc == 0 and all(len(p["replicas"]) == 3
                           for p in plan["partitions"])
