"""PyTorch port, on the card: every CUDA kernel (B1, the fused site sweep
B2+B3, the fused exchange sweep B4+B5+B6) against its plain PyTorch
version on small seeded instances — padded bucket rows, RF 1 and mixed
RF included — B1 also at 1 and 8 chains and at 30,000 brokers, the fused
exchange sweep also at 2, 3 and 5 partitions (partners off the end in
every sweep), at the main path's bucket and at a bucket of more blocks
than the card holds at once, and the ``cuda`` sweep bundle against the
``torch`` bundle over 16 sweeps, and the chain engine's rounds replayed
as CUDA graphs against its eager step loop, on one model and in lane
form. The lane forms of the three
kernels (one launch for L lanes) against L launches of the single-lane
wrappers and against their lane plain versions, at L = 1, 3 and 8, on a
portfolio's mixed configs and on a batch whose tables and bands differ;
more lanes than one launch takes, split into launches of lane groups;
the lane stepper's ``cuda`` bundle against its ``torch`` bundle; the
exchange launcher's host draws against ``prng``'s; and the pipelined
ladder's two promises on the card: a chunk enqueued from the retired
chunk's state and then abandoned leaves the retired chunk's outputs as a
synchronous run left them, and the asynchronous fetch equals a blocking
copy; ``kao-router`` in front of a worker solving on the card; and the
solve mesh on the card: two chain shards of three lanes as one launch of
each kernel, and a two-shard solve over ``[cuda:0, cuda:0]`` equal to
the CPU's two-shard run; and ``kao-check``'s runtime contracts on the
card, with the kernels' launches of each step; and the fused group as
replays of its bucket's step graph against the group run eagerly (on
one model and on three lanes, armed and disarmed, the launch counts
after the replays), from two threads at once. Exact equality throughout.

These tests need an NVIDIA GPU and skip without one. They import no JAX,
so they also run where only the port's dependencies exist:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu_torch import prng
from kafka_assignment_optimizer_tpu_torch.models.cluster import (
    Assignment,
    PartitionAssignment,
    Topology,
)
from kafka_assignment_optimizer_tpu_torch.models.instance import (
    build_instance,
)
from kafka_assignment_optimizer_tpu_torch.ops import (
    exchange_cuda,
    kernels,
    score_cuda,
    site_cuda,
)
from kafka_assignment_optimizer_tpu_torch.ops import score as tscore
from kafka_assignment_optimizer_tpu_torch.parallel.mesh import (
    fetch_global_async,
    init_lane_state,
    init_sweep_state,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import (
    anneal,
    arrays,
    sweep,
)
from kafka_assignment_optimizer_tpu_torch.solvers.tpu.seed import greedy_seed

pytestmark = pytest.mark.cuda

# B+1 is below the site sweep's 8 CTAs per chain in the last case and no
# multiple of 8 in any; the fourth case's 2,500 partitions are no
# multiple of a CTA's threads
CASES = [
    dict(nb=14, npart=40, rfs=(3,), nr=3, drop=1, bucket=(48, 4)),
    dict(nb=8, npart=13, rfs=(1,), nr=2, drop=0, bucket=None),
    dict(nb=20, npart=70, rfs=(2, 4), nr=5, drop=2, bucket=(80, 5)),
    dict(nb=30, npart=2_500, rfs=(3, 2), nr=4, drop=1, bucket=None),
    dict(nb=6, npart=24, rfs=(2, 3), nr=2, drop=1, bucket=(32, 3)),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels.build_all()
    return torch.device("cuda")


def _model(case, dev, n=5):
    rng = np.random.default_rng(len(case["rfs"]) * 100 + case["npart"])
    parts = [
        PartitionAssignment("t", p, [int(b) for b in rng.choice(
            case["nb"], size=case["rfs"][p % len(case["rfs"])],
            replace=False)])
        for p in range(case["npart"])
    ]
    topo = Topology(rack_of={b: f"r{b % case['nr']}"
                             for b in range(case["nb"])})
    inst = build_instance(Assignment(partitions=parts),
                          list(range(case["nb"] - case["drop"])), topo)
    kw = {} if case["bucket"] is None else dict(
        num_parts=case["bucket"][0], max_rf=case["bucket"][1])
    m = arrays.from_instance(inst, dev, **kw)
    seed = arrays.pad_candidate(greedy_seed(inst), m)
    a = np.broadcast_to(seed, (n, *seed.shape)).copy()
    sl = rng.integers(0, inst.max_rf, size=(n, inst.num_parts))
    bk = rng.integers(0, inst.num_brokers, size=(n, inst.num_parts))
    a[np.arange(n)[:, None], np.arange(inst.num_parts)[None, :], sl] = bk
    a[~np.broadcast_to(m.slot_valid.cpu().numpy(), a.shape)] = \
        inst.num_brokers
    return m, torch.from_numpy(a).to(dev), torch.from_numpy(seed).to(dev)


def _equal(xs, ys):
    for i, (x, y) in enumerate(zip(xs, ys)):
        assert torch.equal(x, y), f"output {i} differs"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("temp", [2.0, 0.05])
def test_kernels_equal_plain_versions(card, case, temp):
    m, a, _seed = _model(case, card)
    t = float(np.float32(temp))
    _equal(score_cuda.score(m, a), score_cuda.score_plain(m, a))
    _f, _r, cnt, lcnt, rcnt = sweep.histograms(m, a)
    key = prng.PRNGKey(3)
    ref = sweep._site_sweep_delta(m, a, cnt, lcnt, rcnt, key, t)
    _equal(site_cuda.site_step_cuda(m, a, cnt, lcnt, rcnt, key, t), ref)
    _equal(exchange_cuda.exchange_step_cuda(m, a, cnt, lcnt, rcnt, key, t),
           sweep._exchange_sweep_delta(m, a, cnt, lcnt, rcnt, key, t))
    torch.cuda.synchronize()


# B1 at 1 chain (the verification call) and 8 (the sweep's), and at more
# brokers than B1's old shared-memory histograms took (29,000)
@pytest.mark.parametrize("case", [
    *CASES, dict(nb=30_001, npart=64, rfs=(3,), nr=8, drop=1, bucket=None)])
@pytest.mark.parametrize("n", [1, 8])
def test_score_equals_plain_version(card, case, n):
    m, a, _seed = _model(case, card, n)
    out = score_cuda.score(m, a)
    ref = score_cuda.score_plain(m, a)
    _equal(out, ref)
    assert (out[0][:, 5] == tscore.moves_batch(a, m)).all()
    torch.cuda.synchronize()


def _equal_sweep(m, a, lcnt, key, t):
    """The fused exchange sweep against its plain version: the five
    records and both maps against ``sweep.exchange_propose``; phase 2 (a
    and lcnt') against ``sweep.exch_finish`` fed with the kernel's own
    records and maps."""
    a2, lcnt2, rec, m_out, m_in = exchange_cuda.exchange_sweep_cuda(
        m, a, lcnt, key, t)
    p, r_out, r_in = sweep.exchange_propose(m, a, lcnt, key, t)
    _equal((*rec, m_out, m_in),
           (p.s, p.b_other, p.tok_out, p.tok_in, p.prio, r_out, r_in))
    f_a, d_lcnt = sweep.exch_finish(a, *rec, m_out, m_in)
    _equal((a2, lcnt2), (f_a, lcnt + d_lcnt))


# the fused exchange sweep at partition counts where most sweeps have
# partitions whose partner falls off the end (2, 3, 5), the padded bucket
# of CASES[0], the main path's bucket (10,240 rows, RF up to 4, with 240
# padded rows), and a bucket of 5 x 512 blocks of 256 partitions, more
# than the 132 x 8 that an H100 holds at once (2,048 threads an SM): the
# cooperative grid's loops take more than one turn
EXCH_CASES = [
    dict(nb=4, npart=2, rfs=(2,), nr=2, drop=0, bucket=None),
    dict(nb=8, npart=3, rfs=(2, 3), nr=2, drop=1, bucket=None),
    dict(nb=8, npart=5, rfs=(3,), nr=3, drop=1, bucket=None),
    CASES[0],
    dict(nb=256, npart=10_000, rfs=(2, 4), nr=8, drop=1,
         bucket=(10_240, 4)),
    dict(nb=30, npart=2_500, rfs=(3, 2), nr=4, drop=1,
         bucket=(131_072, 4)),
]


@pytest.mark.parametrize("case", EXCH_CASES)
@pytest.mark.parametrize("temp", [2.0, 0.05])
def test_exchange_proposal_equals_plain_version(card, case, temp):
    m, a, _seed = _model(case, card)
    _f, _r, cnt, lcnt, rcnt = sweep.histograms(m, a)
    t = float(np.float32(temp))
    for i in range(4):
        key = prng.PRNGKey(40 + i)
        _equal_sweep(m, a, lcnt, key, t)
        _equal(
            exchange_cuda.exchange_step_cuda(m, a, cnt, lcnt, rcnt, key, t),
            sweep._exchange_sweep_delta(m, a, cnt, lcnt, rcnt, key, t))
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", CASES)
def test_cuda_bundle_replays_torch_bundle(card, case):
    m, _a, seed = _model(case, card)
    temps = arrays.geometric_temps(2.0, 0.02, 16)
    runs = []
    for scorer in ("cuda", "torch"):
        step = sweep.make_sweep_stepper_fn(4, scorer=scorer)
        st = init_sweep_state(m, seed, prng.PRNGKey(9), 4)
        outs = []
        for chunk in (temps[:8], temps[8:]):
            st, top_a, top_k, curve = step(m, st, chunk)
            outs.append((*st[:4], top_a, top_k, curve))
        runs.append(outs)
    for xs, ys in zip(*runs):
        _equal(xs, ys)


# 40 steps a round: one graph of 32 steps and one of the 8 left
@pytest.mark.parametrize("case", [CASES[0], CASES[2]])
def test_chain_round_graphs_replay_eager_steps(card, case):
    m, _a, seed = _model(case, card)
    keys = anneal.chain_keys(prng.PRNGKey(4), 6, card)
    runs = []
    for graph in (True, False):
        run = anneal.make_round_runner(40, graph=graph)
        st = anneal.init_chain(m, seed, keys)
        bk, ba = anneal.best_key(st), st.a.clone()
        outs = []
        for temp in (2.0, 0.5, 0.05):
            st, bk, ba = run(m, st, bk, ba, np.float32(temp))
            st = anneal._migrate(st, anneal.best_key(st), 1)
            outs.append((st.a, st.cnt, st.lcnt, st.rcnt, st.pen, st.w,
                         st.key, bk, ba))
        runs.append(outs)
    for xs, ys in zip(*runs):
        _equal(xs, ys)


def test_chain_lanes_graphs_equal_lane_by_lane(card):
    """The chain engine's lane form on the card (every lane's chains one
    axis, a round's steps replayed as CUDA graphs, each chain its lane's
    bands, penalty scale and temperature) equals each lane run alone on
    the CPU, on a portfolio's mixed configs."""
    ms, _a, seeds = _portfolio_lanes(CASES[0], card, 3)
    ms_cpu, _a, seeds_cpu = _portfolio_lanes(CASES[0], "cpu", 3)
    keys = np.stack([prng.PRNGKey(i) for i in range(3)])
    temps = arrays.geometric_temps(2.5, 0.05, 3)
    got = anneal.make_lane_solver_fn(4, 40)(ms, seeds, keys, temps)
    solo = anneal.make_solver_fn(4, 40)
    for lane in range(3):
        want = solo(arrays.lane_model(ms_cpu, lane), seeds_cpu[lane],
                    keys[lane], temps)
        _equal([x[lane].cpu() for x in got], want)


def _portfolio_lanes(case, dev, L):
    """L lanes of one instance on the portfolio's configs (cycling past
    the table's 8), each lane its own chain order: ``(stacked model,
    chains [L, N, P, R], seeds [L, P, R])``."""
    m, a, seed = _model(case, dev)
    ms = arrays.stack_models([arrays.with_config(m, c)
                              for c in arrays.portfolio_configs(L)])
    return (ms, torch.stack([a.roll(i, 0) for i in range(L)]),
            seed[None].repeat(L, 1, 1))


def _batch_lanes(dev, L):
    """L instances whose tables and bands differ (partition counts and
    RFs vary), one bucket, 13 brokers in 3 racks each."""
    ms, pops, seeds = [], [], []
    for i in range(L):
        case = dict(nb=14 + i % 2, npart=40 - 3 * i,
                    rfs=(3, 2, 1)[:1 + i % 3], nr=3, drop=1 + i % 2,
                    bucket=(48, 4))
        m, a, seed = _model(case, dev)
        ms.append(m)
        pops.append(a)
        seeds.append(seed)
    return arrays.stack_models(ms), torch.stack(pops), torch.stack(seeds)


def _lane_inputs(ms, a, temp):
    L = a.shape[0]
    _out, cnt, lcnt, rcnt = score_cuda.score_lanes_plain(ms, a)
    scales = ms.lane_scalars()[2]
    temps = [float(np.float32(temp) * np.float32(s)) for s in scales]
    keys = [prng.fold_in(prng.PRNGKey(7), i) for i in range(L)]
    return (cnt, lcnt, rcnt), keys, temps


def _stack(outs):
    return tuple(torch.stack(x) for x in zip(*outs))


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("kind", ["portfolio", "batch"])
@pytest.mark.parametrize("temp", [2.0, 0.05])
def test_lane_kernels_equal_solo_launches_and_plain(card, L, kind, temp):
    ms, a, _seeds = (_portfolio_lanes(CASES[2], card, L) if kind ==
                     "portfolio" else _batch_lanes(card, L))
    (cnt, lcnt, rcnt), keys, temps = _lane_inputs(ms, a, temp)
    lanes = [arrays.lane_model(ms, i) for i in range(L)]
    # B1
    got = score_cuda.score_lanes(ms, a)
    _equal(got, score_cuda.score_lanes_plain(ms, a))
    _equal(got, _stack(score_cuda.score(lanes[i], a[i]) for i in range(L)))
    # the site sweep
    got = site_cuda.site_step_lanes(ms, a, cnt, lcnt, rcnt, keys, temps)
    _equal(got, sweep.site_lanes_delta(ms, a, cnt, lcnt, rcnt, keys, temps))
    _equal(got, _stack(site_cuda.site_step_cuda(
        lanes[i], a[i], cnt[i], lcnt[i], rcnt[i], keys[i], temps[i])
        for i in range(L)))
    assert (got[0] != a).any()
    # the exchange sweep, its records and maps included
    a2, l2, rec, m_out, m_in = exchange_cuda.exchange_sweep_lanes(
        ms, a, lcnt, keys, temps)
    solo = [exchange_cuda.exchange_sweep_cuda(lanes[i], a[i], lcnt[i],
                                              keys[i], temps[i])
            for i in range(L)]
    _equal((a2, l2, *rec, m_out, m_in),
           _stack((x[0], x[1], *x[2], x[3], x[4]) for x in solo))
    _equal(exchange_cuda.exchange_step_lanes(ms, a, cnt, lcnt, rcnt, keys,
                                             temps),
           sweep.exchange_lanes_delta(ms, a, cnt, lcnt, rcnt, keys, temps))
    torch.cuda.synchronize()


def test_lane_launch_counts_and_limits(card):
    """One launch a lane call up to ``MAX_LANES`` lanes, and one a group
    of up to ``MAX_LANES`` lanes past it, equal to the lane plain
    versions, on shared tables and on stacked ones; state of another
    lane count raises instead of running."""
    ms, a, _seeds = _portfolio_lanes(CASES[0], card, 8)
    (cnt, lcnt, rcnt), keys, temps = _lane_inputs(ms, a, 0.5)
    before = [k.launches for k in kernels.KERNELS]
    score_cuda.score_lanes(ms, a)
    site_cuda.site_step_lanes(ms, a, cnt, lcnt, rcnt, keys, temps)
    exchange_cuda.exchange_step_lanes(ms, a, cnt, lcnt, rcnt, keys, temps)
    assert [k.launches - b for k, b in zip(kernels.KERNELS, before)] == \
        [1, 1, 1]
    with pytest.raises(ValueError, match="lanes of state"):
        score_cuda.score_lanes(ms, a[:3])
    L = kernels.MAX_LANES + 1
    shared, a_s, _s = _portfolio_lanes(CASES[0], card, L)
    b8, a8, _s = _batch_lanes(card, 8)
    stacked = arrays.stack_models([arrays.lane_model(b8, i % 8)
                                   for i in range(L)])
    assert shared.w_lead.stride(0) == 0 and stacked.w_lead.stride(0) > 0
    for ms, a in ((shared, a_s),
                  (stacked, torch.stack([a8[i % 8] for i in range(L)]))):
        (cnt, lcnt, rcnt), keys, temps = _lane_inputs(ms, a, 0.5)
        before = [k.launches for k in kernels.KERNELS]
        _equal(score_cuda.score_lanes(ms, a),
               score_cuda.score_lanes_plain(ms, a))
        _equal(site_cuda.site_step_lanes(ms, a, cnt, lcnt, rcnt, keys,
                                         temps),
               sweep.site_lanes_delta(ms, a, cnt, lcnt, rcnt, keys, temps))
        _equal(exchange_cuda.exchange_step_lanes(ms, a, cnt, lcnt, rcnt,
                                                 keys, temps),
               sweep.exchange_lanes_delta(ms, a, cnt, lcnt, rcnt, keys,
                                          temps))
        assert [k.launches - b for k, b in zip(kernels.KERNELS, before)] \
            == [2, 2, 2]
    torch.cuda.synchronize()


@pytest.mark.parametrize("P", [2, 3, 5, 48, 10_240, 131_072])
def test_exchange_launcher_host_keys_equal_prng(card, P):
    for i in range(8):
        key = prng.fold_in(prng.PRNGKey(P), i)
        kb, d, hi, lo = kernels.exchange_host_keys(key, P)
        kb_p, d_p, hi_p, lo_p = exchange_cuda.host_keys(key, P)
        assert d == d_p
        for x, y in ((kb, kb_p), (hi, hi_p), (lo, lo_p)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", ["portfolio", "batch"])
def test_lane_stepper_cuda_bundle_replays_torch_bundle(card, kind):
    ms, _a, seeds = (_portfolio_lanes(CASES[0], card, 3) if kind ==
                     "portfolio" else _batch_lanes(card, 3))
    L = ms.num_lanes
    keys = np.stack([prng.fold_in(prng.PRNGKey(9), i) for i in range(L)])
    temps = arrays.geometric_temps(2.0, 0.02, 16)
    runs = []
    for scorer in ("cuda", "torch"):
        step = sweep.make_lane_stepper_fn(4, scorer=scorer)
        st = init_lane_state(ms, seeds.cpu().numpy(), keys, 4)
        outs = []
        for chunk in (temps[:8], temps[8:]):
            st, top_a, top_k, curve = step(ms, st, chunk)
            outs.append((*st[:4], top_a, top_k, curve))
        runs.append(outs)
    for xs, ys in zip(*runs):
        _equal(xs, ys)


@pytest.mark.parametrize("kind", ["portfolio", "batch"])
def test_two_shard_lane_kernels_equal_plain(card, kind):
    """Two chain shards of three lanes ride one launch of each kernel as
    six lanes (``arrays.shard_models``: the lanes repeated shard-major,
    shared tables still at lane stride 0), equal to the lane plain
    versions."""
    ms, a, _seeds = (_portfolio_lanes(CASES[2], card, 3) if kind ==
                     "portfolio" else _batch_lanes(card, 3))
    ms2 = arrays.shard_models(ms, 2)
    assert ms2.num_lanes == 6
    assert (ms2.w_lead.stride(0) == 0) == (kind == "portfolio")
    a2 = torch.cat([a, a.roll(1, 1)])
    (cnt, lcnt, rcnt), keys, temps = _lane_inputs(ms2, a2, 0.5)
    before = [k.launches for k in kernels.KERNELS]
    _equal(score_cuda.score_lanes(ms2, a2),
           score_cuda.score_lanes_plain(ms2, a2))
    _equal(site_cuda.site_step_lanes(ms2, a2, cnt, lcnt, rcnt, keys, temps),
           sweep.site_lanes_delta(ms2, a2, cnt, lcnt, rcnt, keys, temps))
    _equal(exchange_cuda.exchange_step_lanes(ms2, a2, cnt, lcnt, rcnt, keys,
                                             temps),
           sweep.exchange_lanes_delta(ms2, a2, cnt, lcnt, rcnt, keys, temps))
    assert [k.launches - b for k, b in zip(kernels.KERNELS, before)] == \
        [1, 1, 1]
    torch.cuda.synchronize()


def test_two_shard_solve_on_one_card_equals_cpu(card):
    """A mesh over ``[cuda:0, cuda:0]``: the two shards' lane solve (one
    launch of each kernel a stage for both) and the engine's two-shard
    solve equal the CPU's two-shard runs."""
    from kafka_assignment_optimizer_tpu_torch.parallel import mesh as pm
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

    c0 = torch.device("cuda", 0)
    ms, _a, seeds = _batch_lanes(card, 3)
    ms_cpu, _a, _s = _batch_lanes(torch.device("cpu"), 3)
    keys = np.stack([prng.fold_in(prng.PRNGKey(9), i) for i in range(3)])
    temps = arrays.geometric_temps(2.0, 0.02, 16)
    runs = []
    for m, mesh, scorer in ((ms, pm.make_mesh(device=[c0, c0]), "cuda"),
                            (ms_cpu, pm.make_mesh(2, device="cpu"),
                             "torch")):
        st = init_lane_state(m, seeds.cpu().numpy(), keys, 4, mesh)
        before = [k.launches for k in kernels.KERNELS]
        out = pm.solve_lanes(m, 4, temps, state=st, scorer=scorer,
                             mesh=mesh)
        runs.append([x.cpu() for x in (*out[0][:4], *out[1:])])
        if scorer == "cuda":
            assert [k.launches - b for k, b in zip(kernels.KERNELS,
                                                   before)] == \
                list(sweep.stage_counts(16).values())
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    case = CASES[0]
    rng = np.random.default_rng(3)
    parts = [PartitionAssignment("t", p, [int(b) for b in rng.choice(
        case["nb"], size=3, replace=False)]) for p in range(case["npart"])]
    topo = Topology(rack_of={b: f"r{b % 3}" for b in range(case["nb"])})
    inst = build_instance(Assignment(partitions=parts),
                          list(range(case["nb"] - 1)), topo)
    kw = dict(precompile=True, engine="sweep", sweeps=16, batch=8,
              portfolio=False)
    on_card = engine.solve_tpu(inst, device=[c0, c0], **kw)
    on_cpu = engine.solve_tpu(inst, device="cpu", n_devices=2, **kw)
    np.testing.assert_array_equal(on_card.a, on_cpu.a)
    for f in ("devices", "chains_per_device", "moves", "score_curve"):
        assert on_card.stats[f] == on_cpu.stats[f], f


def test_abandoned_chunk_leaves_the_retired_chunk_intact(card):
    """The pipelined ladder's speculation: chunk 1 enqueued from chunk
    0's state before chunk 0 is retired, then abandoned unread, leaves
    chunk 0's state, winners and curve as a synchronous run left them,
    and chunk 0's fetch (started before chunk 1 was enqueued) holds
    them."""
    m, _a, seed = _model(CASES[3], card)
    temps = arrays.geometric_temps(2.0, 0.02, 32)
    step = sweep.make_sweep_stepper_fn(4, scorer="cuda")
    st = init_sweep_state(m, seed, prng.PRNGKey(9), 4)
    st0, a0, k0, c0 = step(m, st, temps[:16])
    torch.cuda.synchronize()
    want = [x.clone() for x in (*st0[:4], a0, k0, c0)]
    keys = np.array(st0[4])
    st = init_sweep_state(m, seed, prng.PRNGKey(9), 4)
    st0, a0, k0, c0 = step(m, st, temps[:16])
    h = fetch_global_async((a0, k0, c0))
    _st1, _a1, _k1, _c1 = step(m, st0, temps[16:])  # abandoned
    got = h.get()
    torch.cuda.synchronize()
    _equal([*st0[:4], a0, k0, c0], want)
    np.testing.assert_array_equal(st0[4], keys)
    for x, y in zip(got, want[4:]):
        np.testing.assert_array_equal(x, y.cpu().numpy())


def test_async_fetch_equals_blocking_copy(card):
    """``fetch_global_async`` of a tensor and of a tuple, on the card,
    equals ``.cpu()`` of the same tensors, whatever their dtype and
    layout, and ``get`` is idempotent."""
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 10_240, 4), generator=g,
                      device=card, dtype=torch.int32)
    y = torch.rand(8, 128, generator=g, device=card)
    z = x[:, ::3, 1:]  # a non-contiguous view
    one = fetch_global_async(x)
    many = fetch_global_async((y, z, x.sum(-1)))
    np.testing.assert_array_equal(one.get(), x.cpu().numpy())
    np.testing.assert_array_equal(one.get(), x.cpu().numpy())
    for got, t in zip(many.get(), (y, z, x.sum(-1))):
        np.testing.assert_array_equal(got, t.cpu().numpy())


def _chain_case():
    rng = np.random.default_rng(0)
    parts = [PartitionAssignment("t", p, [int(b) for b in rng.choice(
        12, size=2, replace=False)]) for p in range(40)]
    topo = Topology(rack_of={b: f"r{b % 2}" for b in range(12)})
    return Assignment(partitions=parts), list(range(10)), topo


def _sweep_case():
    """A slice of the adversarial family: slack caps and no symmetry, so
    with knobs set no constructor certifies it and the ladder runs."""
    from kafka_assignment_optimizer_tpu_torch.utils import gen

    s = gen.adversarial(n_brokers=24, n_racks=4, n_topics_low=3,
                        n_topics_high=3, parts_per_topic=10)
    return s.current, s.broker_list, s.topology


def test_two_workers_chain_capture_beside_sweep_launches(card):
    """The service's two workers share the card: a chain-engine solve
    (its rounds captured as CUDA graphs on a side stream) and a sweep
    solve (the three kernels launched on the current stream) run at once
    in two threads, three times, and each gives the plan it gives alone."""
    import threading

    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

    kw = {"chain": dict(engine="chain", batch=64, rounds=4,
                        steps_per_round=256),
          "sweep": dict(engine="sweep", batch=8, sweeps=64,
                        portfolio=False)}
    cases = {"chain": _chain_case(), "sweep": _sweep_case()}

    def solve(name):
        inst = build_instance(*cases[name])
        return engine.solve_tpu(inst, seed=0, device="cuda", **kw[name])

    alone = {n: solve(n) for n in kw}
    assert alone["chain"].stats["engine"] == "chain"
    assert alone["sweep"].stats["engine"] == "sweep"
    for _ in range(3):
        got, errs = {}, []

        def run(name):
            try:
                got[name] = solve(name)
            except BaseException as e:  # surfaced below
                errs.append(e)

        ths = [threading.Thread(target=run, args=(n,)) for n in kw]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=600)
        assert not errs, errs
        for n in kw:
            np.testing.assert_array_equal(got[n].a, alone[n].a)
            assert got[n].stats["feasible"] == alone[n].stats["feasible"]


def test_served_solve_launches_the_kernels(card):
    """A ``tpu`` solve through the service on the card (its default
    device) launches all three kernels, and its trace holds the ladder."""
    from kafka_assignment_optimizer_tpu_torch import serve

    srv = serve.make_server(port=0)
    try:
        current, brokers, topo = _sweep_case()
        kernels.reset_counts()
        out = serve.handle_submit({
            "assignment": current.to_dict(), "brokers": brokers,
            "topology": topo.to_dict(), "solver": "tpu",
            "options": {"engine": "sweep", "batch": 8, "sweeps": 32,
                        "portfolio": False}})
    finally:
        srv.server_close()
    counts = [k.launches for k in kernels.KERNELS]
    assert all(c > 0 for c in counts), counts
    assert out["report"]["solver_device"].startswith("cuda")
    rep = serve._otrace.RECENT.get(out["trace_id"])
    assert "ladder" in rep["phases"]


def test_router_over_a_card_worker(card, tmp_path):
    """``kao-router`` (the port's ``fleet.router``) in front of a worker
    process solving on the card: the routed ``tpu`` solve launches all
    three kernels on the worker (its ``/debug/kernels`` counters), the
    envelope names the worker, and ``/debug/traces/<id>`` attaches the
    worker's solve tree to the router's attempt span under one trace
    ID."""
    import json
    import socket
    import subprocess
    import sys
    import threading
    import time
    import urllib.request
    from pathlib import Path

    from kafka_assignment_optimizer_tpu_torch.fleet import health, router

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    wurl = f"http://127.0.0.1:{port}"
    log = open(tmp_path / "worker.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kafka_assignment_optimizer_tpu_torch.serve",
         "--port", str(port)], cwd=Path(__file__).resolve().parent.parent,
        stdout=log, stderr=subprocess.STDOUT)

    def call(url, path, payload=None):
        req = urllib.request.Request(
            url + path, method="GET" if payload is None else "POST",
            data=None if payload is None else json.dumps(payload).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    rsrv = None
    try:
        for _ in range(480):
            try:
                call(wurl, "/healthz")
                break
            except OSError:
                assert proc.poll() is None, (tmp_path / "worker.log")\
                    .read_text()[-2000:]
                time.sleep(0.25)
        tracker = health.FleetTracker([wurl], interval_s=3600,
                                      timeout_s=5.0)
        tracker.poll_once()
        rtr = router.Router(tracker, lock_wait_s=30.0,
                            solve_timeout_s=300.0, connect_timeout_s=5.0)
        rsrv = router.make_router_server("127.0.0.1", 0, rtr)
        threading.Thread(target=rsrv.serve_forever, daemon=True).start()
        rurl = f"http://127.0.0.1:{rsrv.server_address[1]}"
        current, brokers, topo = _sweep_case()
        before = call(wurl, "/debug/kernels")["launches"]
        out = call(rurl, "/submit", {
            "assignment": current.to_dict(), "brokers": brokers,
            "topology": topo.to_dict(), "solver": "tpu",
            "options": {"engine": "sweep", "batch": 8, "sweeps": 32,
                        "portfolio": False}})
        after = call(wurl, "/debug/kernels")["launches"]
        merged = call(rurl, f"/debug/traces/{out['trace_id']}")
    finally:
        if rsrv is not None:
            rsrv.shutdown()
            rsrv.server_close()
        proc.terminate()
        proc.wait(timeout=60)
        log.close()
    assert out["route"]["worker"] == wurl
    assert out["report"]["solver_device"].startswith("cuda")
    assert all(after[k] > before[k] for k in after), (before, after)
    attached = [p for p in merged["processes"] if p["attached_to"]]
    assert len(attached) == 1
    assert attached[0]["report"]["trace_id"] == out["trace_id"]


def test_sanitizer_nan_guard_on_card(card):
    """Armed, the NaN guard checks card tensors (one host sync) and
    raises on a non-finite value; a solve armed runs every guard at
    every chunk and gives the disarmed plan."""
    from kafka_assignment_optimizer_tpu_torch.analysis import sanitize
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

    ok = torch.ones(4, device=card)
    bad = torch.tensor([1.0, float("nan")], device=card)
    kw = dict(engine="sweep", batch=8, sweeps=32, portfolio=False,
              time_limit_s=300.0, device="cuda")
    ref = engine.solve_tpu(build_instance(*_sweep_case()), **kw)
    sanitize.reset()
    sanitize.enable()
    try:
        sanitize.check_device((ok, torch.zeros(3, dtype=torch.int32,
                                                 device=card)))
        with pytest.raises(FloatingPointError):
            sanitize.check_device((ok, bad))
        got = engine.solve_tpu(build_instance(*_sweep_case()), **kw)
        snap = sanitize.snapshot()
    finally:
        sanitize.disable()
        sanitize.reset()
    np.testing.assert_array_equal(got.a, ref.a)
    assert snap["nan_aborts_total"] == snap["donation_reuse_total"] == 0
    assert snap["recompiles_total"] == 0


def test_kernel_vs_torch_rows_on_the_card(card):
    """The kernel-vs-torch bench on the card at the headline's smoke
    size: one row per launch at L=1 and L=8, each kernel equal to its
    plain version, timed, and reaching no more of its analytic bound
    than a card can (at or below 1.05)."""
    from kafka_assignment_optimizer_tpu_torch.ops import bench_kernel

    rep = bench_kernel.kernel_vs_torch(smoke=True)
    assert rep["platform"] == "gpu" and "skipped" not in rep
    rows = rep["rows"]
    assert len(rows) == 6
    for r in rows:
        assert r["parity"], r
        assert r["ms"] > 0 and r["bound_ms"] > 0
        assert r["share"] <= 1.05, r
    assert [r["library_ms"] is None for r in rows] == [
        False, True, False] * 2


def test_profiler_cost_model_on_the_card(card):
    """A pinned sweep solve on the card: each chunk key's analytic launch
    counts (``sweep.stage_counts`` of its sweeps) equal the launches the
    wrappers counted in the ladder, and its occupancy reads no more than
    a card can."""
    from kafka_assignment_optimizer_tpu_torch.obs import prof
    from kafka_assignment_optimizer_tpu_torch.solvers.tpu import engine

    inst = build_instance(*_sweep_case())
    prof.clear()
    kernels.reset_counts()
    engine.solve_tpu(inst, engine="sweep", batch=8, sweeps=32,
                     portfolio=False, precompile=True, time_limit_s=300.0,
                     cert_min_savings_s=float("inf"))
    counted = {k.name: k.launches for k in kernels.KERNELS}
    (row,) = prof.snapshot()["executables"]
    ladder = {k: v * row["dispatches"] for k, v in row["launches"].items()}
    # final selection and verification add B1 launches of their own
    assert ladder["B2+B3 site sweep"] == counted["B2+B3 site sweep"]
    assert (ladder["B4+B5+B6 exchange sweep"]
            == counted["B4+B5+B6 exchange sweep"])
    assert ladder["B1 score"] <= counted["B1 score"]
    assert row["peak_hbm_bytes"] is not None
    for k in ("occupancy_flops", "occupancy_hbm", "occupancy_hbm_p99"):
        assert row[k] is not None and row[k] <= 1.05, (k, row)


def test_runtime_contracts_on_the_card(card):
    """``kao-check``'s runtime contracts on the card (the ``cuda``
    scorer): zero findings, the sweep stepper's chunk launching B1, the
    site kernel and the exchange kernel as ``sweep.stage_counts`` says,
    the lane stepper at L=2 one launch a stage (the same counts), the
    armed fused groups of two steps (one model, and two lanes) twice
    those counts, and the eager chain round B1 never."""
    from kafka_assignment_optimizer_tpu_torch.analysis.contracts import (
        run_contracts,
    )

    rep = run_contracts(device="cuda")
    assert rep.ok, [f.render() for f in rep.findings]
    assert rep.checks_run >= 16 and rep.ops > 0
    want = sweep.stage_counts(8)
    assert rep.launches["sweep stepper"] == want
    assert rep.launches["lane stepper"] == want
    assert all(n > 0 for n in want.values())
    for step in ("group stepper", "lane group stepper"):
        assert rep.launches[step] == {k: 2 * v for k, v in want.items()}
    assert rep.launches["chain round"] == {k.name: 0
                                           for k in kernels.KERNELS}


# ------------------------------------------------------ the group graph

def _group_case(dev, L):
    """A fused group's inputs on the card: ``(stepper factory, model,
    state with device keys)``, one model (``L`` 0) or ``L`` portfolio
    lanes."""
    if L == 0:
        m, _a, seed = _model(CASES[0], dev)
        st = init_sweep_state(m, seed, prng.PRNGKey(4), 4)
        fn = sweep.make_mega_stepper_fn
    else:
        m, _a, seeds = _portfolio_lanes(CASES[0], dev, L)
        st = init_lane_state(m, seeds.cpu().numpy(),
                             [prng.fold_in(prng.PRNGKey(4), i)
                              for i in range(L)], 4)
        fn = sweep.make_mega_lane_stepper_fn
    return fn, m, (*st[:4], prng.to_device_keys(st[4], dev))


# a padded tail (the third step inactive); armed, thresholds every
# chain meets from its seed (the group exits after its first step)
GROUP_TEMPS = np.stack([arrays.geometric_temps(2.0, 0.02, 24)[i * 8:
                                                             (i + 1) * 8]
                        for i in range(3)])
GROUP_ACTIVE = np.array([True, True, False])
GROUP_ARMS = {"disarmed": (sweep.MEGA_DISARMED_KEY,
                           sweep.MEGA_DISARMED_MOVES),
              "armed": (-(2 ** 31) + 1, 2 ** 31 - 1)}


@pytest.mark.parametrize("L", [0, 3])
@pytest.mark.parametrize("arm", ["disarmed", "armed"])
def test_group_graph_replays_the_eager_group(card, L, arm):
    """A fused group replayed as its bucket's CUDA graph equals the same
    group run eagerly, bit for bit (every output, the carried state and
    its device keys), on one model and on three lanes, disarmed with a
    padded tail and armed with an exit after the first step; the kernels'
    launch counts after the replays equal the eager group's; a second
    group from the replays' state equals the eager continuation; and a
    second seed of the bucket, and a group of another width, replay the
    step graph without a capture."""
    fn, m, st = _group_case(card, L)
    args = (GROUP_TEMPS, GROUP_ACTIVE, *GROUP_ARMS[arm])
    sweep.clear_group_graphs()
    kernels.reset_counts()
    eager = fn(4, scorer="cuda", graph=False)(m, st, *args)
    want = [k.launches for k in kernels.KERNELS]
    kernels.reset_counts()
    got = fn(4, scorer="cuda", graph=True)(m, st, *args)
    assert [k.launches for k in kernels.KERNELS] == want
    assert all(n > 0 for n in want)
    for x, y in zip(eager[0], got[0]):
        assert torch.equal(x, y)
    _equal(eager[1:], got[1:])
    if arm == "armed":
        assert got[7].reshape(-1, 3)[0].tolist() == [True, False, False]
    caps = sweep.GROUP_STATS["captures"]
    again = fn(4, scorer="cuda", graph=True)(m, got[0], *args)
    cont = fn(4, scorer="cuda", graph=False)(m, eager[0], *args)
    for x, y in zip(cont[0], again[0]):
        assert torch.equal(x, y)
    _equal(cont[1:], again[1:])
    _fn, _m, st2 = _group_case(card, L)
    st2 = (*st2[:4], prng.split_rows(st2[4].reshape(-1, 2))[:, 1]
           .reshape(st2[4].shape))
    fn(4, scorer="cuda", graph=True)(m, st2, *args)
    fn(4, scorer="cuda", graph=True)(m, st2, GROUP_TEMPS[:2],
                                     GROUP_ACTIVE[:2], *GROUP_ARMS[arm])
    assert sweep.GROUP_STATS["captures"] == caps


def test_group_graph_is_not_shared_between_threads(card):
    """Two threads replay groups of one bucket at once, each from its own
    seed and on its own stream: each thread's groups equal its groups
    run alone, eagerly (a checked-out instance serves one group at a
    time, and the next group on it waits for the last one's copies)."""
    import threading

    sweep.clear_group_graphs()
    args = (GROUP_TEMPS[:2], np.ones(2, bool), *GROUP_ARMS["disarmed"])
    fn, m, _st = _group_case(card, 0)
    starts = []
    for i in range(2):
        _fn, _m, st = _group_case(card, 0)
        starts.append((*st[:4], prng.split_rows(
            st[4].reshape(-1, 2))[:, i].reshape(st[4].shape)))

    def run(st, graph, out):
        with torch.cuda.stream(torch.cuda.Stream()):
            for _ in range(3):
                res = fn(4, scorer="cuda", graph=graph)(m, st, *args)
                st = res[0]
                out.append(res)
            torch.cuda.current_stream().synchronize()

    solo = []
    for st in starts:
        solo.append([])
        run(st, False, solo[-1])
    outs = [[], []]
    ts = [threading.Thread(target=run, args=(st, True, o))
          for st, o in zip(starts, outs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
        assert not t.is_alive()
    for want, got in zip(solo, outs):
        assert len(got) == 3
        for w, g in zip(want, got):
            for x, y in zip(w[0], g[0]):
                assert torch.equal(x, y)
            _equal(w[1:], g[1:])
    snap = sweep.group_graphs_snapshot()
    assert 1 <= snap["graphs"] <= 2 and snap["keys"] == 1
