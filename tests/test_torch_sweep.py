"""PyTorch port: the sweep engine against the JAX package's XLA path.

Same inputs (seeded numpy populations, the JAX model leaves carried over
with ``from_numpy``, the same threefry keys) through the reference and
the port, compared with EXACT equality: the site proposal records and
sweep, the exchange halves, records, maps and sweep, the compound sweep,
and the stepper over two chunks (with the one-device best migration).
The kernel wrappers run their plain versions here (CPU tensors); the
card holds the kernels to these same functions (chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kafka_assignment_optimizer_tpu.ops.score import moves_batch as jmoves
from kafka_assignment_optimizer_tpu.ops.thin_pallas import (
    exchange_step_pallas,
    site_step_pallas,
)
from kafka_assignment_optimizer_tpu.solvers.tpu import arrays as jarrays
from kafka_assignment_optimizer_tpu.solvers.tpu import sweep as js
from kafka_assignment_optimizer_tpu_torch import prng
from kafka_assignment_optimizer_tpu_torch.ops import exchange_cuda, site_cuda
from kafka_assignment_optimizer_tpu_torch.ops import score as tscore
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import arrays
from kafka_assignment_optimizer_tpu_torch.solvers.tpu import sweep as ts

from tests.test_torch_arrays import assert_same, chains, fast_jit, pair

# a padded bucket (8 inert rows, one invalid slot column) exercises the
# empty-row paths of every proposal
BUCKET = (48, 4)

# the reference functions, jitted once per module: every test below uses
# one model shape, so each compiles once and the temperatures are data
_jit = fast_jit
_J_SCORES = _jit(js.chain_scores)
_J_MOVES = _jit(jmoves)
_J_HISTS = _jit(js._histograms)
_J_PROPOSE = _jit(js.propose_site)
_J_SITE = _jit(js._site_sweep_delta)
_J_HALVES = _jit(js._exchange_halves_xla)
_J_EXCH = _jit(js._exchange_sweep_delta)
_J_PROPOSE_EXCH = _jit(lambda m, a, lcnt, key, temp: js.propose_exchange(
    m, a, key, temp, lcnt=lcnt))
_J_COMP = _jit(js._compound_sweep_delta)
# the JAX package's two site-sweep Pallas kernels, run as its own CPU
# tests run them
_J_SITE_PALLAS = _jit(lambda *args: site_step_pallas(*args, interpret=True))
_J_EXCH_PALLAS = _jit(
    lambda *args: exchange_step_pallas(*args, interpret=True))

# the reference's mesh path with one device: its stepper under a named
# axis of size 1 (the port's engine runs the same one-device migration)
N_STEP = 3
_J_STEP = _jit(jax.vmap(js.make_sweep_stepper_fn(N_STEP, axis_name="x"),
                        in_axes=(None, 0, None), axis_name="x"))


def _setup(rng, n=5):
    inst, mj, mt = pair(rng, nb=14, npart=40, rf=3, nr=3, drop=1,
                        bucket=BUCKET)
    a = chains(inst, mj, rng, n)
    return inst, mj, mt, a, jnp.asarray(a), torch.from_numpy(a)


def _hists(mj, mt, aj, at):
    _f, _r, cj, lj, rj = _J_HISTS(mj, aj)
    _f, _r, ct, lt, rt = ts.histograms(mt, at)
    for x, y in zip((cj, lj, rj), (ct, lt, rt)):
        assert_same(x, y)
    return (cj, lj, rj), (ct, lt, rt)


@pytest.mark.parametrize("temp", [2.0, 0.02])
def test_site_records_and_sweep_delta_match(rng, temp):
    inst, mj, mt, a, aj, at = _setup(rng)
    t32 = np.float32(temp)
    bits = jax.random.bits(jax.random.PRNGKey(3), (*a.shape[:2], 8),
                           jnp.uint32)
    bt = torch.from_numpy(np.asarray(bits).astype(np.int64))
    pj = _J_PROPOSE(mj, aj, bits, t32)
    pt = ts.propose_site(mt, at, bt, float(t32))
    for f in pj._fields:
        assert_same(getattr(pj, f), getattr(pt, f), f)
    assert 0 < int((pt.prio > 0).sum()) < pt.prio.numel()

    hj, ht = _hists(mj, mt, aj, at)
    # the records against carried histograms, as the site sweep draws
    # them, and their thinning maps
    pc = ts.propose_site(mt, at, bt, float(t32), hists=ts._carried(*ht))
    for f in pj._fields:
        assert_same(getattr(pj, f), getattr(pc, f), f)
    assert_same(ts.site_maps(mt, pc)[0], ts.site_maps(mt, pt)[0])

    outj = _J_SITE(mj, aj, *hj, jax.random.PRNGKey(11), t32)
    outt = ts._site_sweep_delta(mt, at, *ht, prng.PRNGKey(11), float(t32))
    outw = site_cuda.site_step_cuda(mt, at, *ht, prng.PRNGKey(11),
                                    float(t32))
    for x, y, z in zip(outj, outt, outw):
        assert_same(x, y)
        assert_same(x, z)
    assert (outt[0].numpy() != a).any()


def test_site_step_matches_reference_pallas_kernels(rng):
    """The fused site sweep's wrapper on CPU tensors against the JAX
    package's two Pallas kernels chained (``site_step_pallas``) in
    interpret mode: one instance, one key, one temperature."""
    inst, mj, mt, a, aj, at = _setup(rng)
    t32 = np.float32(0.3)
    hj, ht = _hists(mj, mt, aj, at)
    outj = _J_SITE_PALLAS(mj, aj, *hj, jax.random.PRNGKey(13), t32)
    outw = site_cuda.site_step_cuda(mt, at, *ht, prng.PRNGKey(13),
                                    float(t32))
    for x, y in zip(outj, outw):
        assert_same(x, y)
    assert (outw[0].numpy() != a).any()


@pytest.mark.parametrize("temp", [2.0, 0.02])
def test_exchange_halves_and_sweep_delta_match(rng, temp):
    inst, mj, mt, a, aj, at = _setup(rng)
    t32 = np.float32(temp)
    hj, ht = _hists(mj, mt, aj, at)
    key_j, key_t = jax.random.PRNGKey(5), prng.PRNGKey(5)

    # the halves' inputs exactly as the port's exchange sweep builds them
    seen = {}

    def capture(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        return ts.exchange_halves(*args, **kw)

    pt = ts.propose_exchange(mt, at, key_t, float(t32), halves=capture,
                             lcnt=ht[1])
    _m, _a, lcnt, s_own, lead_other, b_other = seen["args"]
    ref = _J_HALVES(mj, aj, hj[1], jnp.asarray(s_own.numpy()),
                    jnp.asarray(lead_other.numpy()),
                    jnp.asarray(b_other.numpy()))
    got = ts.exchange_halves(*seen["args"])
    for x, y in zip(ref, got):
        assert_same(x, y)

    assert 0 < int((pt.prio > 0).sum())

    outj = _J_EXCH(mj, aj, *hj, key_j, t32)
    outt = ts._exchange_sweep_delta(mt, at, *ht, key_t, float(t32))
    outw = exchange_cuda.exchange_step_cuda(mt, at, *ht, key_t, float(t32))
    for x, y, z in zip(outj, outt, outw):
        assert_same(x, y)
        assert_same(x, z)


@pytest.mark.parametrize("temp", [2.0, 0.02])
def test_exchange_step_matches_reference_pallas_kernels(rng, temp):
    """The exchange sweep's wrapper on CPU tensors against the JAX
    package's exchange sweep through its three Pallas kernels
    (``exchange_step_pallas``) in interpret mode."""
    inst, mj, mt, a, aj, at = _setup(rng)
    t32 = np.float32(temp)
    hj, ht = _hists(mj, mt, aj, at)
    outj = _J_EXCH_PALLAS(mj, aj, *hj, jax.random.PRNGKey(15), t32)
    outw = exchange_cuda.exchange_step_cuda(mt, at, *ht, prng.PRNGKey(15),
                                            float(t32))
    for x, y in zip(outj, outw):
        assert_same(x, y)
    assert (outw[0].numpy() != a).any()


@pytest.mark.parametrize("P", [2, 5, 48, 10_240])
def test_exchange_host_keys_give_the_reference_pairing(P):
    """The fused exchange kernel's pairing: the wrapper's host draws
    (``exchange_cuda.host_keys``) and the kernel's uint32 phase arithmetic
    (mirrored here in numpy: the randint's two words at counter n) give
    the reference's stride and lower sides (``_pair_partners``)."""
    N = 8
    for i in range(3):
        key = 7 * P + i
        kj, kt = jax.random.PRNGKey(key), prng.PRNGKey(key)
        kd_j, _kb = jax.random.split(kj)
        d_j, low_j, valid_j = js._pair_partners(kd_j, N, P)
        kbits, d, k_hi, k_lo = exchange_cuda.host_keys(kt, P)
        assert d == int(d_j) and 1 <= d < max(P // 2, 2)
        assert_same(jax.random.split(kj)[1], kbits)
        hi = prng.bits(k_hi, (N,)).astype(np.uint32)
        lo = prng.bits(k_lo, (N,)).astype(np.uint32)
        span = np.uint32(2 * d)
        mul = np.uint32((1 << 16) % (2 * d))
        mul = np.uint32(int(mul) * int(mul) % (2 * d))
        with np.errstate(over="ignore"):
            phase = ((hi % span) * mul + lo % span) % span
        p_idx = np.arange(P)[None, :]
        low = ((p_idx + phase.astype(np.int64)[:, None]) // d) % 2 == 0
        assert_same(low_j, low)
        partner = np.where(low, p_idx + d, p_idx - d)
        assert_same(valid_j, (partner >= 0) & (partner < P))


def _np_max_map(tok, prio, width):
    out = np.zeros((tok.shape[0], width), np.float32)
    np.maximum.at(out, (np.arange(tok.shape[0])[:, None], tok), prio)
    return out


# odd partition counts, unbucketed, where every sweep has partitions whose
# partner falls off the end; and the padded bucket of _setup
@pytest.mark.parametrize("shape", [dict(npart=3, bucket=None),
                                   dict(npart=5, bucket=None),
                                   dict(npart=40, bucket=BUCKET)])
def test_exchange_propose_matches_reference(rng, shape):
    """``sweep.exchange_propose`` (the plain version of the fused
    kernel's proposal phase) and the fused sweep's wrapper on CPU
    tensors: the records against the JAX
    ``propose_exchange`` with its XLA halves, the maps against a numpy
    max over those records; three keys, two temperatures."""
    inst, mj, mt = pair(rng, nb=10, npart=shape["npart"], rf=3, nr=3,
                        drop=1, bucket=shape["bucket"])
    a = chains(inst, mj, rng, 6)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    hj, ht = _hists(mj, mt, aj, at)
    B1 = inst.num_brokers + 1
    accepted = 0
    for i, temp in enumerate((2.0, 0.02, 2.0)):
        t32 = np.float32(temp)
        pj = _J_PROPOSE_EXCH(mj, aj, hj[1], jax.random.PRNGKey(30 + i), t32)
        pt, m_out, m_in = ts.exchange_propose(mt, at, ht[1],
                                              prng.PRNGKey(30 + i),
                                              float(t32))
        for f in pj._fields:
            assert_same(getattr(pj, f), getattr(pt, f), f)
        prio = np.asarray(pj.prio)
        assert_same(_np_max_map(np.asarray(pj.tok_out), prio, B1), m_out)
        assert_same(_np_max_map(np.asarray(pj.tok_in), prio, B1), m_in)
        _a2, _l2, rec, w_out, w_in = exchange_cuda.exchange_sweep_cuda(
            mt, at, ht[1], prng.PRNGKey(30 + i), float(t32))
        for f, x in zip(("s", "b_other", "tok_out", "tok_in", "prio"), rec):
            assert_same(getattr(pj, f), x, f)
        assert_same(m_out, w_out)
        assert_same(m_in, w_in)
        accepted += int((pt.prio > 0).sum())
    assert accepted > 0


def test_compound_sweep_delta_matches(rng):
    inst, mj, mt, a, aj, at = _setup(rng)
    hj, ht = _hists(mj, mt, aj, at)
    for i, temp in enumerate((2.0, 0.3)):
        t32 = np.float32(temp)
        outj = _J_COMP(mj, aj, *hj, jax.random.PRNGKey(20 + i), t32)
        outt = ts._compound_sweep_delta(mt, at, *ht, prng.PRNGKey(20 + i),
                                        float(t32))
        for x, y in zip(outj, outt):
            assert_same(x, y)


def _seed_state(inst, mj, n_chains, key_seed=5):
    seed = jnp.asarray(jarrays.pad_candidate(
        np.asarray(chains(inst, mj, np.random.default_rng(1), 1)[0]), mj))
    a = jnp.broadcast_to(seed, (n_chains, *seed.shape))
    w0, p0 = _J_SCORES(mj, a)
    return (a, js.best_key(w0, p0), _J_MOVES(a, mj), a,
            jax.random.PRNGKey(key_seed))


@pytest.mark.parametrize("key_seed", [5, 6])
def test_stepper_two_chunks_match_reference(rng, key_seed):
    """The port's stepper replays the reference's one-device mesh
    stepper over two chunks: same populations, bests, move counts,
    snapshots, key, top plan and curve. Both seeds share one compile of
    the reference."""
    inst, mj, mt, *_ = _setup(rng)
    state_j = _seed_state(inst, mj, N_STEP, key_seed)
    temps = np.asarray(jarrays.geometric_temps(2.0, 0.02, 16))
    sj = jax.tree.map(lambda x: x[None], state_j)
    stt = ts.make_sweep_stepper_fn(N_STEP, scorer="torch")
    st = arrays.state_from_numpy(tuple(np.asarray(x) for x in state_j),
                                 "cpu")
    for chunk in (temps[:8], temps[8:]):
        sj, top_aj, top_kj, cv_j = _J_STEP(mj, sj, jnp.asarray(chunk))
        st, top_at, top_kt, cv_t = stt(mt, st, chunk)
        for x, y in zip(sj, st):
            assert_same(np.asarray(x)[0], y)
        assert_same(np.asarray(top_aj)[0], top_at)
        assert_same(np.asarray(top_kj)[0], top_kt)
        assert_same(np.asarray(cv_j)[0], cv_t)

    # chunking changes nothing: the uncut run lands on the same state
    st0 = arrays.state_from_numpy(tuple(np.asarray(x) for x in state_j),
                                  "cpu")
    su, top_au, top_ku, _cv = stt(mt, st0, temps)
    for x, y in zip(st, su):
        assert_same(np.asarray(x), y)


def test_delta_stepper_matches_from_scratch_loop(rng):
    """The carried-histogram stepper equals the explicit from-scratch
    loop (every sweep rebuilds the histograms, every snapshot migrates
    the best chain), as the reference pins its own delta engine; an odd
    tail exercises the final snapshot."""
    inst, mj, mt, *_ = _setup(rng)
    N, snap, sweeps = 3, 4, 17
    state_j = _seed_state(inst, mj, N)
    state = arrays.state_from_numpy(tuple(np.asarray(x) for x in state_j),
                                    "cpu")
    temps = arrays.geometric_temps(2.0, 0.02, sweeps)
    (a, bk, bmv, ba, key), top_a, top_k, curve = ts.make_sweep_stepper_fn(
        N, snapshot_every=snap)(mt, state, temps)

    a_r, bk_r, bmv_r, ba_r, key_r = arrays.state_from_numpy(
        tuple(np.asarray(x) for x in state_j), "cpu")
    curve_r = []
    for i in range(sweeps):
        key_r, sub = prng.split(key_r)
        t = float(temps[i])
        if i % ts.COMPOUND_EVERY == ts.COMPOUND_EVERY - 1:
            a_r = ts.compound_sweep(mt, a_r, sub, t)
        elif i % 2 == 1:
            a_r = ts.exchange_sweep(mt, a_r, sub, t)
        else:
            a_r = ts.sweep_once(mt, a_r, sub, t)
        if i % snap == snap - 1 or i == sweeps - 1:
            k = ts.best_key(*ts.chain_scores(mt, a_r))
            mv = tscore.moves_batch(a_r, mt)
            imp = (k > bk_r) | ((k == bk_r) & (mv < bmv_r))
            bmv_r = torch.where(imp, mv, bmv_r)
            bk_r = torch.where(imp, k, bk_r)
            ba_r = torch.where(imp[:, None, None], a_r, ba_r)
            _f, _r, c, lc, rc = ts.histograms(mt, a_r)
            a_r, _c, _l, _rc, bk_r, bmv_r, ba_r = ts._migrate(
                a_r, c, lc, rc, k, mv, bk_r, bmv_r, ba_r)
        curve_r.append(int(bk_r.max()))
    for x, y in zip((a, bk, bmv, ba), (a_r, bk_r, bmv_r, ba_r)):
        assert torch.equal(x, y)
    assert curve.tolist() == curve_r
    assert (key == key_r).all()


def test_solver_fn_is_the_stepper_from_the_broadcast_seed(rng):
    inst, mj, mt, a, aj, at = _setup(rng, n=1)
    seed, key = at[0], prng.PRNGKey(4)
    temps = arrays.geometric_temps(2.0, 0.02, 8)
    top_a, top_k, curve = ts.make_sweep_solver_fn(3)(mt, seed, key, temps)
    pop = seed[None].repeat(3, 1, 1)
    w, pen = ts.chain_scores(mt, pop)
    state = (pop, ts.best_key(w, pen), tscore.moves_batch(pop, mt), pop.clone(),
             key)
    _st, top_a2, top_k2, curve2 = ts.make_sweep_stepper_fn(3)(mt, state,
                                                              temps)
    assert torch.equal(top_a, top_a2) and torch.equal(curve, curve2)
    assert int(top_k) == int(top_k2) >= int(ts.best_key(w, pen)[0])


def test_cuda_bundle_needs_the_card(rng):
    inst, mj, mt, a, aj, at = _setup(rng, n=2)
    step = ts.make_sweep_stepper_fn(2, scorer="cuda")
    st = (at, torch.zeros(2, dtype=torch.int32),
          torch.zeros(2, dtype=torch.int32), at.clone(), prng.PRNGKey(0))
    with pytest.raises(ValueError, match="runs on the card"):
        step(mt, st, np.ones(2, np.float32))
    with pytest.raises(ValueError, match="unknown scorer"):
        ts.make_sweep_stepper_fn(2, scorer="pallas")


def test_first_index_reductions():
    x = torch.tensor([3, 1, 4, 1, 5, 5])
    assert int(ts.first_argmin(x)) == 1
    assert int(ts.first_argmax(x)) == 4


# ------------------------------------------------ the chunk step's device draws

def _dkey(seed):
    """``PRNGKey(seed)`` as a device key (int64 words, here on the CPU)."""
    return prng.to_device_keys(prng.PRNGKey(seed), "cpu")


@pytest.mark.parametrize("P", [2, 3, 5, 48])
def test_device_key_draws_match_reference(P):
    """The draws a chunk step makes from device keys: a lane's key split
    once a sweep (``prng.split_chain``), host and device alike, equal
    ``jax.random.split`` applied in turn; ``randint`` with device bounds
    and the pairing (``_pair_partners``: the stride as a device scalar,
    the phases, the lower sides) equal the reference's."""
    kj = jax.random.PRNGKey(9 * P)
    keys = np.stack([prng.PRNGKey(9 * P), prng.fold_in(prng.PRNGKey(P), 3)])
    subs_h, keys_h = prng.split_chain(keys, 5)
    subs_d, keys_d = prng.split_chain(prng.to_device_keys(keys, "cpu"), 5)
    assert_same(subs_h, subs_d)
    assert_same(keys_h, keys_d)
    k = kj
    for i in range(5):
        k, sub = jax.random.split(k)
        assert_same(sub, subs_d[i, 0])
    assert_same(k, keys_d[0])
    span = torch.tensor(2 * P, dtype=torch.int64)
    assert_same(jax.random.randint(kj, (4, 1), 0, 2 * P),
                prng.randint(_dkey(9 * P), (4, 1), 0, span))
    kd_j, _ = jax.random.split(kj)
    d_j, low_j, valid_j = js._pair_partners(kd_j, 6, P)
    d_t, low_t, valid_t = ts._pair_partners(prng.split(_dkey(9 * P))[0], 6,
                                            P, "cpu")
    assert isinstance(d_t, torch.Tensor) and int(d_t) == int(d_j)
    assert_same(low_j, low_t)
    assert_same(valid_j, valid_t)


# the stages as the chunk step calls them: a device key and a float32
# device temperature; at 3 partitions every sweep's stride is 1 and the
# partners past the end wrap
@pytest.mark.parametrize("stage", ["site", "exchange", "compound"])
@pytest.mark.parametrize("shape", [dict(npart=3, bucket=None),
                                   dict(npart=40, bucket=BUCKET)])
def test_device_draw_stages_match_reference(rng, stage, shape):
    """Each sweep stage of the chunk step, given its sweep key as a device
    key and its temperature as a device scalar (a row of the chunk's
    temperature table), equals the reference's stage on the same inputs,
    through the plain version and through the kernel wrapper's CPU
    path."""
    inst, mj, mt = pair(rng, nb=10, npart=shape["npart"], rf=3, nr=3,
                        drop=1, bucket=shape["bucket"])
    a = chains(inst, mj, rng, 5)
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    hj, ht = _hists(mj, mt, aj, at)
    ref, plain, wrapper = {
        "site": (_J_SITE, ts._site_sweep_delta, site_cuda.site_step_cuda),
        "exchange": (_J_EXCH, ts._exchange_sweep_delta,
                     exchange_cuda.exchange_step_cuda),
        "compound": (_J_COMP, ts._compound_sweep_delta, None)}[stage]
    moved = 0
    for i, temp in enumerate((2.0, 0.3)):
        t32 = np.float32(temp)
        tt = torch.tensor(t32)
        outj = ref(mj, aj, *hj, jax.random.PRNGKey(40 + i), t32)
        for fn in (plain, wrapper):
            if fn is None:
                continue
            outt = fn(mt, at, *ht, _dkey(40 + i), tt)
            for x, y in zip(outj, outt):
                assert_same(x, y)
        moved += int((outt[0].numpy() != a).any(-1).sum())
    assert moved > 0


@pytest.mark.parametrize("key_seed", [5])
def test_device_key_stepper_matches_reference(rng, key_seed):
    """The single-model stepper whose state carries its key as a device
    key (as a fused ladder's does): two chunks equal the reference's
    one-device stepper leaf for leaf, the key coming back a device key."""
    inst, mj, mt, *_ = _setup(rng)
    state_j = _seed_state(inst, mj, N_STEP, key_seed)
    temps = np.asarray(jarrays.geometric_temps(2.0, 0.02, 16))
    sj = jax.tree.map(lambda x: x[None], state_j)
    stt = ts.make_sweep_stepper_fn(N_STEP, scorer="torch")
    st = arrays.state_from_numpy(tuple(np.asarray(x) for x in state_j),
                                 "cpu")
    st = (*st[:4], prng.to_device_keys(st[4], "cpu"))
    for chunk in (temps[:8], temps[8:]):
        sj, top_aj, top_kj, cv_j = _J_STEP(mj, sj, jnp.asarray(chunk))
        st, top_at, top_kt, cv_t = stt(mt, st, chunk)
        assert isinstance(st[4], torch.Tensor)
        for x, y in zip(sj, st):
            assert_same(np.asarray(x)[0], y)
        assert_same(np.asarray(top_aj)[0], top_at)
        assert_same(np.asarray(top_kj)[0], top_kt)
        assert_same(np.asarray(cv_j)[0], cv_t)
