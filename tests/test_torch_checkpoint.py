"""PyTorch port: checkpoint write, load and resume against the reference's,
on the CPU.

The port's ``utils.checkpoint`` writes the reference's file format (each
package loads the other's file), keys it by the same instance
fingerprint, and refuses a foreign or corrupt file. Through the engine,
on the reference's own seeded case: a solve writes its verified plan
before certification, the same file in every dispatch mode and fused
width and the same as the reference's; a re-solve resumes from it
(``resumed_from_checkpoint``) and replays to the reference's resumed
plan; a failed write is the ``checkpoint_skipped`` rung; the host
fallback resumes from a checkpoint that outranks the greedy seed; and
the CLI takes ``--checkpoint``, ``--no-pipeline`` and ``--megachunk``.
"""

import numpy as np
import pytest

from kafka_assignment_optimizer_tpu.api import optimize as jax_optimize
from kafka_assignment_optimizer_tpu.cli import main as jcli_main
from kafka_assignment_optimizer_tpu.models.instance import (
    build_instance as jax_build,
)
from kafka_assignment_optimizer_tpu.resilience import chaos as jchaos
from kafka_assignment_optimizer_tpu.solvers.tpu import engine as jengine
from kafka_assignment_optimizer_tpu.utils import checkpoint as jckpt
from kafka_assignment_optimizer_tpu_torch.cli import main as cli_main
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    demo_assignment,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.resilience import chaos
from kafka_assignment_optimizer_tpu_torch.utils import checkpoint as ckpt

from tests.test_torch_engine import _cli_report, port_cluster
from tests.test_torch_pipeline import (
    KW,
    _no_worker,
    assert_same,
    no_race,  # noqa: F401  (a fixture)
    port_solve,
    ref_solve,
    the_cluster,
)

RESUME = ("engine", "rounds_run", "score_curve", "final_cert", "moves",
          "feasible", "degradations", "resumed_from_checkpoint")


def test_checkpoint_format_is_the_reference_s(tmp_path):
    """The same fingerprint; each package loads the other's file; a plan
    saved for another instance, a wrong shape and a corrupt file load as
    None."""
    cl = the_cluster()
    inst_j = jax_build(*cl)
    inst_t = build_instance(*port_cluster(*cl))
    assert ckpt.instance_fingerprint(inst_t) == \
        jckpt.instance_fingerprint(inst_j)
    a = np.asarray(inst_t.a0, np.int32)
    ckpt.save(tmp_path / "t.npz", inst_t, a, meta={"k": 1})
    jckpt.save(tmp_path / "j.npz", inst_j, a, meta={"k": 1})
    np.testing.assert_array_equal(jckpt.load(tmp_path / "t.npz", inst_j), a)
    np.testing.assert_array_equal(ckpt.load(tmp_path / "j.npz", inst_t), a)
    assert not list(tmp_path.glob("*.tmp*"))  # the write is atomic
    other = build_instance(*port_cluster(cl[0], cl[1][:-1], cl[2]))
    assert ckpt.load(tmp_path / "t.npz", other) is None
    ckpt.save(tmp_path / "short.npz", inst_t, a[:-1])
    assert ckpt.load(tmp_path / "short.npz", inst_t) is None
    (tmp_path / "bad.npz").write_bytes(b"not a zip")
    assert ckpt.load(tmp_path / "bad.npz", inst_t) is None
    assert ckpt.load(tmp_path / "missing.npz", inst_t) is None


def test_checkpoint_write_and_resume_across_modes(no_race, tmp_path):
    """Pipelined, synchronous and fused (K=2) solves write the same file
    as the reference's; a re-solve from each resumes
    (``resumed_from_checkpoint``), equals the reference's resumed solve,
    and lands on the first solve's plan."""
    cl = the_cluster()
    inst_t = build_instance(*port_cluster(*cl))
    want_path = str(tmp_path / "ref" / "ck.npz")
    want = ref_solve(cl, pipeline=True, checkpoint=want_path)
    want2 = ref_solve(cl, pipeline=True, checkpoint=want_path)
    assert want2.solve.stats["resumed_from_checkpoint"] is True
    saved = jckpt.load(want_path, jax_build(*cl))
    for name, kw in (("pipe", dict(pipeline=True)),
                     ("sync", dict(pipeline=False)),
                     ("mega", dict(pipeline=True, megachunk=2))):
        path = str(tmp_path / name / "ck.npz")  # the directory is made
        got = port_solve(cl, checkpoint=path, **kw)
        assert got.solve.stats["resumed_from_checkpoint"] is False
        assert_same(got, want, RESUME)
        np.testing.assert_array_equal(ckpt.load(path, inst_t), saved)
        got2 = port_solve(cl, checkpoint=path, **kw)
        assert_same(got2, want2, RESUME)
        np.testing.assert_array_equal(got2.solve.a, got.solve.a)


@pytest.fixture
def chaos_off():
    yield
    chaos.disarm()
    jchaos.disarm()


def test_checkpoint_write_failure_is_the_skipped_rung(no_race, tmp_path,
                                                      chaos_off):
    """An injected write failure (``checkpoint_write``) is the
    ``checkpoint_skipped`` rung: the verified plan is still returned, no
    file is left, as in the reference."""
    cl = the_cluster()
    chaos.arm("checkpoint_write")
    jchaos.arm("checkpoint_write")
    got = port_solve(cl, checkpoint=str(tmp_path / "t.npz"))
    want = ref_solve(cl, checkpoint=str(tmp_path / "j.npz"))
    assert got.solve.stats["degradations"] == ["checkpoint_skipped"]
    assert_same(got, want, RESUME)
    assert not (tmp_path / "t.npz").exists()


def test_host_fallback_resumes_from_checkpoint(no_race, tmp_path, chaos_off,
                                              monkeypatch):
    """The host fallback (an injected NaN) takes a checkpoint that ranks
    at least as high as the greedy seed, as the reference's does (whose
    ``precompile=True`` refuses the fallback: its race workers are stood
    down instead)."""
    for name in ("_construct_worker", "_exact_worker", "_reseat_worker"):
        monkeypatch.setattr(jengine, name, _no_worker)
    cl = the_cluster()
    inst_t = build_instance(*port_cluster(*cl))
    path = tmp_path / "ck.npz"
    first = port_solve(cl, checkpoint=str(path))
    assert first.solve.stats["feasible"]
    jckpt.save(tmp_path / "j.npz", jax_build(*cl), first.solve.a)
    chaos.arm("nan_chunk")
    jchaos.arm("nan_chunk")
    got = port_solve(cl, checkpoint=str(path))
    want = jax_optimize(*cl, n_devices=1, checkpoint=str(tmp_path / "j.npz"),
                        **KW)
    st = got.solve.stats
    assert st["engine"] == "host_fallback" and st["resumed_from_checkpoint"]
    assert_same(got, want, ("engine", "moves", "feasible", "degradations",
                            "resumed_from_checkpoint"))
    assert inst_t.is_feasible(got.solve.a)


def test_cli_checkpoint_pipeline_and_megachunk_flags(tmp_path, capsys,
                                                     monkeypatch):
    """``--checkpoint`` writes the plan and a second run resumes from it;
    ``--no-pipeline`` and ``--megachunk 2`` reach the engine; a bad
    ``--megachunk`` exits 2 in both CLIs, and ``auto`` runs in both with
    the same report."""
    import functools

    from kafka_assignment_optimizer_tpu.solvers import base as jbase

    jbase._load_all()
    monkeypatch.setitem(jbase._REGISTRY, "tpu", functools.partial(
        jengine.solve_tpu, n_devices=1))
    src = tmp_path / "demo.json"
    src.write_text(demo_assignment().to_json())
    ck = tmp_path / "ck" / "plan.npz"
    argv = ["-i", str(src), "--broker-list", "0-18", "--topology",
            "even-odd", "--solver", "tpu", "--engine", "sweep", "--sweeps",
            "16", "--time-limit", "3600", "--checkpoint", str(ck),
            "--no-pipeline", "--megachunk", "2", "--report", "--device",
            "cpu"]
    keys = ("solver_pipeline", "solver_dispatches", "replica_moves",
            "solver_resumed_from_checkpoint", "feasible")
    rc, rep, err = _cli_report(cli_main, argv, capsys)
    assert rc == 0, err
    assert rep["solver_pipeline"] is False and ck.exists()
    rc, rep2, err = _cli_report(cli_main, argv, capsys)
    assert rc == 0 and rep2["solver_resumed_from_checkpoint"] is True
    rc_j, ref, _ = _cli_report(jcli_main, argv[:-2], capsys)
    assert rc_j == 0
    assert {k: rep2.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    for main in (cli_main, jcli_main):
        bad = argv[:-2] if main is jcli_main else argv
        bad = [x if x != "2" else "two" for x in bad]
        rc, _rep, err = _cli_report(main, bad, capsys)
        assert rc == 2 and "--megachunk" in err
    # the measured width: "auto" parses in both CLIs and reports alike
    # (from empty evidence tables: the earlier solves of this process
    # differ between the packages)
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
        engine as tengine,
    )

    auto = [x if x != "2" else "auto" for x in argv]
    for mod in (tengine, jengine):
        mod.reset_megachunk_adapt()
    rc, rep3, err = _cli_report(cli_main, auto, capsys)
    rc_j, ref3, _ = _cli_report(jcli_main, auto[:-2], capsys)
    for mod in (tengine, jengine):
        mod.reset_megachunk_adapt()
    assert rc == rc_j == 0, err
    # (how many chunks run before the boundary certificate stops the
    # ladder follows each package's chunk times on this CPU: the
    # dispatches of an auto width are compared in test_torch_megachunk)
    same = [k for k in keys if k != "solver_dispatches"]
    assert {k: rep3.get(k) for k in same} == {k: ref3.get(k) for k in same}
    assert rep3["solver_megachunk"]["mode"] == \
        ref3["solver_megachunk"]["mode"] == "auto"
