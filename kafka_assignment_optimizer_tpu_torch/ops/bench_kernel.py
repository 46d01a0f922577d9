"""Kernel-vs-torch micro-benchmark and the cost models of the three
CUDA launches.

The reference package's ``ops.bench_kernel.kernel_vs_xla`` times its
Pallas scorer against XLA on the headline instance. Here
:func:`kernel_vs_torch` times each of the three hand-written launches —
B1 (``csrc/score.cu``), the fused site sweep B2+B3 (``csrc/site.cu``)
and the fused exchange sweep B4+B5+B6 (``csrc/exchange.cu``) — at one
lane and at eight, on the ``decommission`` headline instance (256
brokers, 8 racks, 10,000 partitions, RF 3), against its plain PyTorch
version and, where one exists, one PyTorch call computing the same
function (:func:`library_calls`: ``torch.bincount`` for B1's replica
histogram, ``scatter_reduce_`` amax for the exchange sweep's maps). A
row whose kernel disagrees with its plain version reports no time.

Two cost models:

- :func:`data_cost` is the bound: what one launch must do on the inputs
  it is given — each input and output once, a gathered weight-table or
  ``a0`` entry once per distinct entry the launch's data addresses,
  threefry at ``THREEFRY_OPS_PER_WORD`` integer instructions a word
  (counted in the SASS of ``csrc/common.cuh``'s ``threefry_word`` on an
  H100). Where the work depends on the data it counts what the data
  needs and leaves out what it cannot see (the proposals' arithmetic,
  the rejected pairs' reads), so the bound stays below the least time.
  ``kernel_vs_torch`` and ``chip_smoke.py`` take their bounds from it.
- :func:`launch_cost` / :func:`dispatch_cost` is the roofline profiler's
  (``obs.prof``) estimate from the shapes alone, fixed at a dispatch
  key's first dispatch: bytes an upper estimate (every gathered read
  counted, up to its table's size), operations the threefry words that
  every partition and chain draws. It is not the bound.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

N_CHAINS = 8
LANES = (1, 8)
REPS = 20  # launches per timed window
WINDOWS = 5  # timed windows (the median is kept)
THREEFRY_OPS_PER_WORD = 71
SITE_WORDS = 7  # threefry words a site proposal draws per partition
SITE_FP_OPS = 9  # float work per site proposal: 7 scales, the delta's mul+sub
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores

SCORE, SITE, EXCHANGE = ("B1 score", "B2+B3 site sweep",
                         "B4+B5+B6 exchange sweep")


def _table_bytes(m, *fields) -> int:
    """Bytes of the stacked model's tables, a table the lanes share
    (lane stride 0) counted once."""
    total = 0
    for f in fields:
        t = getattr(m, f)
        lanes = 1 if t.stride(0) == 0 else t.shape[0]
        total += lanes * t[0].numel() * t.element_size()
    return total


def dispatch_shape(m, n_chains: int) -> dict:
    """What the cost model reads of a stacked model ``m`` (``[L, ...]``)
    run with ``n_chains`` chains a lane: the sizes, the table bytes each
    launch reads, and the valid slots and the rows with replicas summed
    over the lanes (one host read of each)."""
    L, P, R = m.a0.shape
    shared = all(getattr(m, f).stride(0) == 0 for f in ("w_lead", "w_foll"))
    return {
        "L": int(L), "N": int(n_chains), "P": int(P), "R": int(R),
        "B1": int(m.num_brokers + 1), "K1": int(m.rack_lo.shape[-1]),
        "valid": int(m.slot_valid.sum()),
        "real": int((m.rf > 0).sum()),
        "weight_entries": (1 if shared else int(L)) * 2 * int(P)
        * int(m.num_brokers + 1),
        "a0_entries": (1 if m.a0.stride(0) == 0 else int(L)) * int(P * R),
        "tables": {
            SCORE: _table_bytes(m, "slot_valid", "part_rack_hi", "rack_of",
                                "rack_lo", "rack_hi"),
            SITE: _table_bytes(m, "rf", "slot_valid", "part_rack_hi",
                               "rack_of", "rack_lo", "rack_hi"),
            EXCHANGE: _table_bytes(m, "rf", "slot_valid", "part_rack_hi",
                                   "rack_of"),
        },
    }


def launch_cost(kernel: str, s: dict) -> dict:
    """``{"bytes", "int_ops", "fp_ops"}`` of one launch of ``kernel`` (a
    ``ops.kernels`` name) at the shape ``s`` (:func:`dispatch_shape`),
    estimated from the shapes alone: the bytes an upper estimate (every
    gathered read counted, up to its table's size), the operations the
    threefry words that every partition and chain draws."""
    L, N, P, R, B1, K1 = (s[k] for k in ("L", "N", "P", "R", "B1", "K1"))
    chains = L * N
    a = chains * P * R * 4
    if kernel == SCORE:
        # w_lead at every valid slot (the moves), w_foll at the followers
        reads = N * (2 * s["valid"] - s["real"])
        return {
            "bytes": a + s["tables"][SCORE]
            + 4 * min(reads, s["weight_entries"])
            + chains * (8 + 2 * B1 + K1) * 4,
            "int_ops": chains * P * R * (12 + 2 * R),
            "fp_ops": 0,
        }
    if kernel == SITE:
        proposals = N * s["real"]
        state = a + chains * (2 * B1 + K1) * 4
        return {
            # state in and out, the tables, the a0 entry of each proposal
            # and at most four weights a proposal (a leader swap reads
            # both tables at both brokers)
            "bytes": 2 * state + s["tables"][SITE]
            + 4 * min(proposals, s["a0_entries"])
            + 4 * min(4 * proposals, s["weight_entries"]),
            "int_ops": proposals * SITE_WORDS * THREEFRY_OPS_PER_WORD,
            "fp_ops": proposals * SITE_FP_OPS,
        }
    if kernel == EXCHANGE:
        # two weights for each partition that could be an accepted half;
        # a slot word for each partition with replicas, two a chain for
        # the phase (a priority word per accepted pair is left out)
        words = N * s["real"] + 2 * chains
        return {
            "bytes": 2 * (a + chains * B1 * 4) + s["tables"][EXCHANGE]
            + 4 * min(2 * N * s["real"], s["weight_entries"]),
            "int_ops": words * THREEFRY_OPS_PER_WORD,
            "fp_ops": words,
        }
    raise ValueError(f"no cost model for kernel {kernel!r}")


def dispatch_cost(launches: dict, s: dict) -> dict:
    """The summed :func:`launch_cost` of ``launches`` (kernel name ->
    count) at the shape ``s``."""
    out = {"bytes": 0, "int_ops": 0, "fp_ops": 0}
    for name, n in launches.items():
        if n:
            c = launch_cost(name, s)
            for k in out:
                out[k] += n * c[k]
    return out


def bound_ms(cost: dict, peaks: dict) -> tuple[float, str]:
    """The least time the card could take for ``cost``: the larger of its
    bytes over the memory rate and its operations over the INT32 and
    FP32 rates; and which of the two bounds it."""
    t_bytes = cost["bytes"] / peaks["bytes_s"]
    t_ops = max(cost["int_ops"] / peaks["flops"],
                cost["fp_ops"] / FP32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def gathered(B1: int, *reads) -> int:
    """Bytes of the distinct weight-table entries that ``reads`` address.
    Each read is ``(table, b, mask, lane)``: ``table`` is 0 for ``w_lead``
    and 1 for ``w_foll`` (an int or an [N, P] tensor), ``b`` the broker
    indices [N, P], ``mask`` (broadcast to [N, P]) the entries read, and
    ``lane`` the lane whose tables they are (0 where the lanes share
    one pair). Both tables are [P, B+1] int32 a lane."""
    keys = []
    for table, b, mask, lane in reads:
        P = b.shape[1]
        k = (((2 * lane + torch.as_tensor(table, device=b.device)) * P
              + torch.arange(P, device=b.device)[None, :]) * B1 + b.long())
        mask = torch.as_tensor(mask, device=b.device)
        keys.append(k[torch.broadcast_to(mask, k.shape)])
    return int(torch.unique(torch.cat(keys)).numel()) * 4


def data_cost(kernel: str, ms, al, hists, keys, temps,
              ops_per_word: float = THREEFRY_OPS_PER_WORD) -> dict:
    """``{"bytes", "int_ops", "fp_ops"}`` that one launch of ``kernel``
    must do on these inputs: the chains ``al [L, N, P, R]`` of the
    stacked model ``ms``, ``hists = (cnt, lcnt, rcnt)`` as
    ``score_lanes`` gives them, and the lanes' sweep keys and
    temperatures. Each input and output once (a table the lanes share,
    lane stride 0, once), the distinct ``a0`` and weight entries the
    launch's reads address, threefry at ``ops_per_word`` a word. The
    launch's outputs are computed here (the kernel on the card, its plain
    version on the CPU)."""
    from .. import prng
    from ..solvers.tpu import arrays, sweep
    from . import exchange_cuda
    from .score_cuda import score_lanes
    from .site_cuda import site_step_lanes

    L, N, P, R = al.shape
    dev = al.device
    B1 = ms.num_brokers + 1
    cnt, lcnt, rcnt = hists
    own = 0 if ms.w_lead.stride(0) == 0 else 1  # the lanes' own weights
    lanes = [arrays.lane_model(ms, i) for i in range(L)]
    real = N * int(sum(int((mi.rf > 0).sum()) for mi in lanes))

    def weights(reads_of) -> int:
        return gathered(B1, *((t, b, mk, own * i) for i in range(L)
                              for t, b, mk in reads_of(i)))

    if kernel == SCORE:
        # w_lead at every valid slot (the moves), w_foll at the followers
        def reads(i):
            sv = lanes[i].slot_valid
            return [(t, al[i, :, :, r], sv[None, :, r]) for t, r in
                    [(0, r) for r in range(R)] + [(1, r) for r in range(1, R)]]

        return {"bytes": nbytes(al) + _table_bytes(
                    ms, "slot_valid", "part_rack_hi", "rack_of", "rack_lo",
                    "rack_hi")
                + weights(reads) + nbytes(*score_lanes(ms, al)),
                "int_ops": L * N * P * R * (12 + 2 * R), "fp_ops": 0}
    if kernel == SITE:
        # a replace reads its slot's table at the old and the new broker, a
        # leader swap both tables at both brokers (legal proposals only);
        # the a0 entry of each proposal's slot; no random words, no records
        a0_keys, site_reads = [], []
        for i, mi in enumerate(lanes):
            bits = prng.bits(keys[i], (N, P, 8), dev)
            pp = sweep.propose_site(mi, al[i], bits, temps[i],
                                    hists=sweep._carried(cnt[i], lcnt[i],
                                                         rcnt[i]))
            s_orig = sweep._rand_idx(arrays.u01(bits[..., 3]), R)
            a0_keys.append((torch.arange(P, device=dev)[None] * R + s_orig)
                           .reshape(-1)
                           + (0 if ms.a0.stride(0) == 0 else i * P * R))
            in_row = ((al[i] == pp.b_new[..., None])
                      & mi.slot_valid[None]).any(-1)
            legal = torch.where(pp.is_lsw, mi.rf > 1, ~in_row) & (mi.rf > 0)
            rep_, lsw = legal & ~pp.is_lsw, legal & pp.is_lsw
            tbl = (pp.s != 0).to(torch.int64)
            site_reads.append([(tbl, pp.b_new, rep_), (tbl, pp.b_at_s, rep_),
                               (0, pp.b_lead, lsw), (1, pp.b_lead, lsw),
                               (0, pp.b_at_s, lsw), (1, pp.b_at_s, lsw)])
        out = site_step_lanes(ms, al, cnt, lcnt, rcnt, keys, temps)
        return {"bytes": nbytes(al, cnt, lcnt, rcnt) + _table_bytes(
                    ms, "rf", "slot_valid", "part_rack_hi", "rack_of",
                    "rack_lo", "rack_hi")
                + int(torch.unique(torch.cat(a0_keys)).numel()) * 4
                + weights(lambda i: site_reads[i]) + nbytes(*out),
                # the seven words of each partition with replicas; the
                # float work the scale of each uniform, the delta's
                # multiply and subtract
                "int_ops": round(real * SITE_WORDS * ops_per_word),
                "fp_ops": real * SITE_FP_OPS}
    if kernel == EXCHANGE:
        # an accepted pair's sides read their slot's table at the broker
        # each gives and takes; the outputs are a_new and lcnt' (the
        # records and maps are the kernel's scratch, a cost of its
        # design). Words: a slot word for each partition with replicas, a
        # priority word for each accepted pair, two a chain for the phase;
        # left out: the rejected pairs' weights, the Metropolis words, the
        # wrapped partners' slot words
        ex = exchange_cuda.exchange_sweep_lanes(ms, al, lcnt, keys, temps)
        s_own, b_other, acc = ex[2][0], ex[2][1], ex[2][4] > 0
        b_own = al.gather(3, s_own.clamp(min=0)[..., None].long())[..., 0]
        tbl = (s_own != 0).to(torch.int64)
        words = real + int(acc.sum()) // 2 + 2 * N * L
        return {"bytes": nbytes(al, lcnt) + _table_bytes(
                    ms, "rf", "slot_valid", "part_rack_hi", "rack_of")
                + weights(lambda i: [(tbl[i], b_other[i], acc[i]),
                                     (tbl[i], b_own[i], acc[i])])
                + nbytes(ex[0], ex[1]),
                "int_ops": round(words * ops_per_word), "fp_ops": words}
    raise ValueError(f"no cost model for kernel {kernel!r}")


def library_calls(ms, al, ex) -> dict:
    """The one-call PyTorch yardsticks of the three launches on the chains
    ``al [L, N, P, R]`` of ``ms`` (``ex``: ``exchange_sweep_lanes``'s
    outputs on them): kernel name -> ``(label, fn)``, or None where no
    single call computes the launch's function. B1: the replica histogram
    of every chain in one ``torch.bincount``; the exchange sweep: its
    maps in one ``scatter_reduce_`` amax over both token sets side by
    side (``fn`` returns the maps, ``[L * N, 2 (B + 1)]``; None when
    ``ex`` is None)."""
    L, N = al.shape[:2]
    B1 = ms.num_brokers + 1
    dev = al.device
    flat = torch.where(ms.slot_valid[:, None], al, ms.num_brokers)
    hist_keys = (torch.arange(L * N, device=dev).reshape(L, N, 1, 1) * B1
                 + flat).reshape(-1)
    out = {SCORE: ("torch.bincount", lambda: torch.bincount(
               hist_keys, minlength=L * N * B1)),
           SITE: None, EXCHANGE: None}
    if ex is not None:
        idx = torch.cat([ex[2][2], ex[2][3] + B1], -1).reshape(L * N,
                                                                -1).long()
        src = torch.cat([ex[2][4], ex[2][4]], -1).reshape(L * N, -1)
        maps = torch.zeros(L * N, 2 * B1, dtype=torch.float32, device=dev)
        out[EXCHANGE] = ("Tensor.scatter_reduce_ amax",
                         lambda: maps.scatter_reduce_(1, idx, src, "amax"))
    return out


def population(device, scenario: str = "decommission",
               smoke: bool = False):
    """A scenario of ``gen.SCENARIOS`` (``SMOKE_KWARGS`` size when
    ``smoke``) lowered to its bucket on ``device``, and ``N_CHAINS``
    chains of its greedy seed with one seeded random slot change per
    partition: ``(scenario, inst, m, seed [P, R] numpy, a [N, P, R])``."""
    from ..models.instance import build_instance
    from ..solvers.tpu import arrays, bucket
    from ..solvers.tpu.seed import greedy_seed
    from ..utils import gen

    sc = gen.SCENARIOS[scenario](
        **(gen.SMOKE_KWARGS[scenario] if smoke else {}))
    inst = build_instance(sc.current, sc.broker_list, sc.topology,
                          sc.target_rf)
    P, R = bucket.bucket_shape(inst)
    m = arrays.from_instance(inst, device, num_parts=P, max_rf=R)
    rng = np.random.default_rng(0)
    seed = arrays.pad_candidate(greedy_seed(inst), m)
    a = np.broadcast_to(seed, (N_CHAINS, P, R)).copy()
    sl = rng.integers(0, inst.max_rf, size=(N_CHAINS, inst.num_parts))
    bk = rng.integers(0, inst.num_brokers, size=(N_CHAINS, inst.num_parts))
    a[np.arange(N_CHAINS)[:, None], np.arange(inst.num_parts)[None, :],
      sl] = bk
    a[~np.broadcast_to(np.asarray(m.slot_valid.cpu()), a.shape)] = \
        inst.num_brokers
    return sc, inst, m, seed, torch.from_numpy(a).to(device)


def _lanes(m, a, L: int):
    """L lanes of the headline: the ``PORTFOLIO_TABLE`` configs over the
    shared tables (one lane: the model itself), lane i with the chains
    rolled by i, its own sweep key and its scaled temperature."""
    from .. import prng
    from ..solvers.tpu import arrays

    ms = (arrays.stack_models([m]) if L == 1 else arrays.stack_models(
        [arrays.with_config(m, c) for c in arrays.portfolio_configs(L)]))
    al = torch.stack([a.roll(i, 0) for i in range(L)])
    temps = [float(np.float32(0.5) * np.float32(x))
             for x in ms.lane_scalars()[2]]
    keys = [prng.fold_in(prng.PRNGKey(11), i) for i in range(L)]
    return ms, al, keys, temps


def timed_ms(fn, on_card: bool = True, reps: int = REPS,
              windows: int = WINDOWS) -> float:
    """Median milliseconds a call over ``windows`` windows of ``reps``
    calls after a warm-up: CUDA events on the card, the host clock on
    the CPU."""
    for _ in range(min(reps, 3)):
        fn()
    times = []
    for _ in range(windows):
        if on_card:
            # this thread's stream only: a device-wide synchronize would
            # fail another thread's CUDA-graph capture in progress
            torch.cuda.current_stream().synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(reps):
                fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(times)


def _equal(xs, ys) -> bool:
    return all(torch.equal(x, y) for x, y in zip(xs, ys))


def kernel_vs_torch(smoke: bool = False, device="cuda",
                    scenario: str = "decommission") -> dict:
    """Time the three launches at each lane count of ``LANES`` on the
    headline instance (or another ``gen.SCENARIOS`` entry) against their
    plain versions and PyTorch calls.
    Returns a JSON-able report with one row a launch and lane count. On
    the card (the default; raises without one) every row carries the
    kernel's CUDA-event time, its plain version's, the library call's
    where there is one, the bound (:func:`data_cost` of the row's inputs
    over :func:`obs.prof.peaks`) and the share of it reached,
    and ``parity`` (the kernel's outputs equal its plain version's on the
    same inputs); a row whose parity fails has no time. With
    ``device="cpu"`` the kernels cannot run: the rows carry the plain
    versions' host-clock times only, and ``skipped`` says why."""
    from ..obs import prof
    from ..solvers.tpu import sweep
    from ..utils.platform import pin_platform
    from . import exchange_cuda, kernels
    from .score_cuda import score_lanes, score_lanes_plain
    from .site_cuda import site_step_lanes

    dev = torch.device(pin_platform(device))
    on_card = dev.type == "cuda"
    _sc, inst, m, _seed, a = population(dev, scenario, smoke)
    P, R = m.a0.shape
    report: dict = {
        "platform": "gpu" if on_card else "cpu",
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "scenario": scenario,
        "partitions": int(inst.num_parts),
        "brokers": int(inst.num_brokers),
        "bucket": [int(P), int(R)],
        "chains": N_CHAINS,
        "rows": [],
    }
    if not on_card:
        report["skipped"] = (
            "the CUDA kernels need an NVIDIA card (device=cpu); the rows "
            "time the plain versions on the host clock, and their parity "
            "with the kernels is checked on the card")
    peaks = prof.peaks() if on_card else None
    for L in LANES:
        ms, al, keys, temps = _lanes(m, a, L)
        _o, cnt, lcnt, rcnt = score_lanes_plain(ms, al)
        library = library_calls(ms, al, exchange_cuda.exchange_sweep_lanes(
            ms, al, lcnt, keys, temps))
        # the kernels as the ladder calls them: the lanes' keys and
        # temperatures already on the card
        dkeys, dtemps = kernels.lane_values(keys, temps, L, al.device)
        calls = {
            SCORE: (lambda: score_lanes(ms, al),
                    lambda: score_lanes_plain(ms, al)),
            SITE: (lambda: site_step_lanes(ms, al, cnt, lcnt, rcnt, dkeys,
                                           dtemps),
                   lambda: sweep.site_lanes_delta(ms, al, cnt, lcnt, rcnt,
                                                  keys, temps)),
            EXCHANGE: (lambda: exchange_cuda.exchange_step_lanes(
                ms, al, cnt, lcnt, rcnt, dkeys, dtemps),
                lambda: sweep.exchange_lanes_delta(
                    ms, al, cnt, lcnt, rcnt, keys, temps)),
        }
        for name, (kernel, plain) in calls.items():
            cost = data_cost(name, ms, al, (cnt, lcnt, rcnt), keys, temps)
            lib = library[name]
            row = {"name": name, "lanes": L, **cost,
                   "library": lib[0] if lib else None}
            row["plain_ms"] = timed_ms(plain, on_card, reps=2, windows=3)
            if on_card:
                row["parity"] = _equal(kernel(), plain())
                if row["parity"]:
                    row["ms"] = timed_ms(kernel, True)
                    row["bound_ms"], row["bound_by"] = bound_ms(cost, peaks)
                    row["share"] = row["bound_ms"] / row["ms"]
                else:
                    row["error"] = "the kernel disagrees with its plain version"
                row["library_ms"] = timed_ms(lib[1], True) if lib else None
            report["rows"].append(row)
    return report
