"""``kao-router`` — the bucket-affinity fleet front process
(docs/FLEET.md).

An HTTP proxy over N ordinary ``serve.py`` workers:

``POST /submit``
    The request's executable bucket key is computed HOST-SIDE
    (``fleet.affinity`` — no torch on the router) and the live worker
    set is ranked rendezvous-first, warm-first: the worker whose exec
    cache and lane-padded executables already hold this bucket gets
    the solve, so a fleet serves every bucket at warm latency while
    each worker only ever compiles its owned slice. Failover walks the
    ranking on connect failures and 503 sheds — honoring each worker's
    ``Retry-After`` promise (the precise ``retry_after_s`` float from
    the shed body, scoped to the shed's bucket when it names one) —
    and latency-sensitive requests (a ``deadline_s`` field) may hedge:
    after ``--hedge-ms`` without an answer the next-ranked worker gets
    a duplicate (solves are idempotent pure compute), first answer
    wins, capped by the ``--hedge-budget`` concurrent-duplicate
    budget.

``POST /clusters/<id>/events`` and everything under ``/clusters``
    Sticky: one owner worker per cluster id (rendezvous over the live
    set, no warmth bias, no parallel hedging) so epoch fencing still
    sees exactly one writer per cluster. Failover only when the owner
    is dead/shedding — the next rendezvous rank IS the new owner, and
    a shared ``--watch-dir`` (deployment recipe in docs/FLEET.md)
    hands it the durable plan store.

``POST /warmup``
    Fleet warmup orchestration: the shape list is partitioned by
    bucket owner so each bucket compiles exactly ONCE fleet-wide
    (phase 1, owners, concurrent across workers), then — unless
    ``"spread": "owners"`` — every other worker warms the remaining
    buckets from the shared persistent compile cache (phase 2, disk
    hits; the per-shape ``persistent.misses`` deltas in the response
    are the proof nothing compiled twice).

``GET /healthz`` / ``GET /metrics``
    The router's own state: per-worker liveness/warmth/cooldowns,
    affinity hit rate, and the ``kao_router_*`` + ``kao_trace_*``
    families (shared exposition helpers).

``GET /debug/traces`` / ``GET /debug/traces/<trace_id>``
    The fleet trace store (docs/OBSERVABILITY.md "Distributed
    traces"): every routed request runs under a causal trace — route
    decisions, per-worker attempts with their Retry-After verdicts,
    hedge launches and wins — whose context is ``inject()``-ed into
    every upstream call as a W3C ``traceparent`` header. Solve
    traffic (``/submit``) ADOPTS it worker-side, so the solve trace
    carries the SAME trace ID; cluster commands carry the header but
    the delta solve keeps its own ID (event coalescing means one
    solve can serve many clients' events — adopting one would alias
    the rest, and a fenced event provably births no trace at all) and
    joins the story via cluster/epoch attrs and ``rollout_root``
    instead.
    ``/debug/traces/<id>`` fans ``GET /debug/solves/<id>`` out to the
    live workers, unions the remote span trees under the router's root
    span (``obs.causal``), and ``?format=chrome`` exports the merged
    tree as ONE Perfetto file with per-process track groups — the
    hedge duplicate's worker included. Clients carrying their own
    ``traceparent`` are joined to it; responses echo the context and a
    successful ``/submit`` envelope carries ``route``: the answering
    worker plus both attempt span IDs (primary + hedge), so a hedge
    win is attributable client-side. ``KAO_TRACE_TAIL`` arms
    tail-based retention on the router's ring exactly as on workers.

The router is stdlib-only and imports neither torch nor jax (pinned by
test).
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..obs import causal as _ocausal
from ..obs import chrome as _ochrome
from ..obs import expo as _expo
from ..obs import log as _olog
from ..obs import trace as _otrace
from . import affinity as _aff
from .health import FleetTracker

__all__ = ["Router", "make_router_server", "render_router_metrics",
           "main"]

MAX_BODY_BYTES = 64 << 20

DEFAULT_LOCK_WAIT_S = 30.0
DEFAULT_SOLVE_TIMEOUT_S = 600.0
DEFAULT_CONNECT_TIMEOUT_S = 5.0
DEFAULT_HEDGE_MS = 250.0
DEFAULT_HEDGE_BUDGET = 2

_RETRY_REASONS = ("connect_fail", "shed", "cooldown_wait", "error")


class Router:
    """Routing state + policy. Pure logic over a :class:`FleetTracker`
    — the HTTP handler below is a thin shell, so tests drive this
    class directly against fake workers."""

    def __init__(self, tracker: FleetTracker, *,
                 lock_wait_s: float = DEFAULT_LOCK_WAIT_S,
                 solve_timeout_s: float = DEFAULT_SOLVE_TIMEOUT_S,
                 connect_timeout_s: float = DEFAULT_CONNECT_TIMEOUT_S,
                 hedge_ms: float = DEFAULT_HEDGE_MS,
                 hedge_budget: int = DEFAULT_HEDGE_BUDGET):
        self.tracker = tracker
        self.lock_wait_s = float(lock_wait_s)
        self.solve_timeout_s = float(solve_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.hedge_s = max(float(hedge_ms), 0.0) / 1e3
        self.hedge_budget = max(int(hedge_budget), 0)
        self._hedges_inflight = 0
        self._lock = threading.Lock()
        self._rr = 0  # round-robin cursor for unkeyed routes
        self.counters = {
            "requests_total": {},        # route -> n
            "affinity_hits_total": 0,    # keyed request -> warm worker
            "affinity_misses_total": 0,  # keyed request -> cold worker
            "affinity_unkeyed_total": 0,  # no computable bucket key
            "retries_total": {r: 0 for r in _RETRY_REASONS},
            "hedges_total": 0,
            "hedge_wins_total": 0,
            "sticky_total": 0,           # cluster-sticky routed
            "exhausted_total": 0,        # router-originated 503s
            "warmups_total": 0,
            "proxied_total": 0,          # upstream responses relayed
        }

    # -- low-level proxy ---------------------------------------------

    def _proxy_once(self, url: str, method: str, path: str,
                    body: bytes | None, timeout: float,
                    headers: dict | None = None,
                    ) -> tuple[int, dict, bytes]:
        """One upstream exchange. Raises OSError-family on transport
        failure; returns (status, headers, body) otherwise. Connect
        runs under the SHORT timeout (a dead host must fail over in
        seconds), then the socket is re-armed with the long read
        timeout (a solve may legitimately hold the line for minutes).
        ``headers`` carries per-attempt extras — the ``traceparent``
        context _attempt_one injects (KAO111)."""
        parsed = urllib.parse.urlsplit(url)
        conn_cls = (http.client.HTTPSConnection
                    if parsed.scheme == "https"
                    else http.client.HTTPConnection)
        conn = conn_cls(parsed.hostname, parsed.port,
                        timeout=self.connect_timeout_s)
        try:
            conn.connect()
            if conn.sock is not None:
                conn.sock.settimeout(timeout)
            send_headers = {"Content-Type": "application/json",
                            **(headers or {})}
            conn.request(method, path, body=body, headers=send_headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def _count(self, key, sub=None, n: int = 1) -> None:
        with self._lock:
            c = self.counters[key]
            if isinstance(c, dict):
                c[sub] = c.get(sub, 0) + n
            else:
                self.counters[key] = c + n

    @staticmethod
    def _shed_info(status: int, headers: dict,
                   data: bytes) -> tuple[float, list | None] | None:
        """(retry_after_s, bucket|None) when the response is a 503
        shed; None otherwise. Prefers the body's precise float over
        the integer header."""
        if status != 503:
            return None
        retry_after, bucket = None, None
        try:
            body = json.loads(data)
            retry_after = float(body["retry_after_s"])
            bucket = body.get("bucket")
        except (KeyError, ValueError, TypeError):
            pass
        if retry_after is None:
            # a worker without the precise body float (older build,
            # proxy in between): fall back to the integer header
            try:
                retry_after = float(headers.get("Retry-After", 1))
            except (TypeError, ValueError):
                retry_after = 1.0
        if not isinstance(bucket, list):
            bucket = None
        return max(retry_after, 0.05), bucket

    # -- routing core ------------------------------------------------

    def _ranked(self, key, *, warm: dict | None = None,
                sticky: str | None = None) -> list[str]:
        live = self.tracker.live()
        if sticky is not None:
            return _aff.rendezvous_rank(("cluster", sticky), live)
        if key is None:
            # unkeyed traffic rotates so it cannot convoy one worker
            with self._lock:
                self._rr += 1
                rot = self._rr
            ranked = sorted(live)
            return ranked[rot % len(ranked):] + \
                ranked[: rot % len(ranked)] if ranked else []
        return _aff.rank_workers(key, live, warm)

    def route(self, method: str, path: str, body: bytes | None, *,
              key=None, sticky: str | None = None,
              hedge: bool = False,
              timeout: float | None = None,
              info: dict | None = None) -> tuple[int, dict, bytes]:
        """Proxy one request with ranked failover. Returns the first
        non-shed upstream answer (any status — a worker's 400/422/500
        is a real verdict and is relayed), failing over on transport
        errors and 503 sheds while honoring per-worker Retry-After.
        Exhaustion returns a router-originated 503 with the soonest
        cooldown as Retry-After.

        Runs under the caller's ambient trace when one is active: each
        ranking pass lands a ``route_decision`` span, each upstream
        try an ``attempt`` span (its context ``inject()``-ed
        downstream so the worker's solve tree roots under it), and
        cooldown sleeps a ``cooldown_wait`` span. ``info`` (when given)
        collects the attribution the HTTP shell merges into the
        response envelope: answering worker + both attempt span IDs."""
        timeout = self.solve_timeout_s if timeout is None else timeout
        parent_sp = _otrace.current_span()
        t_end = time.time() + self.lock_wait_s
        first_choice_counted = False
        soonest = None
        while True:
            # ONE warm-map snapshot per pass: ranking and the affinity
            # hit/miss verdict must agree (two snapshots could race a
            # concurrent poll), and the copy is a locked full clone of
            # every worker's ledger — once per pass, not twice
            warm = (self.tracker.warm_map()
                    if key is not None and sticky is None else None)
            ranked = self._ranked(key, warm=warm, sticky=sticky)
            if parent_sp is not None:
                dsp = _otrace.open_span(parent_sp, "route_decision")
                _otrace.close_span(
                    dsp,
                    bucket=(str(list(key)) if key is not None
                            else None),
                    sticky=sticky,
                    ranked=",".join(ranked),
                    warm_first=bool(
                        key is not None and ranked
                        and tuple(key) in (warm or {}).get(
                            ranked[0], ())
                    ),
                )
            if not ranked:
                break
            for url in ranked:
                if self.tracker.cooling_s(url, key) > 0.0:
                    continue
                if not first_choice_counted and sticky is None:
                    # affinity accounting: did the FIRST actually-
                    # attempted worker hold the bucket warm?
                    first_choice_counted = True
                    if key is None:
                        self._count("affinity_unkeyed_total")
                    elif tuple(key) in (warm or {}).get(url, ()):
                        self._count("affinity_hits_total")
                    else:
                        self._count("affinity_misses_total")
                out = self._attempt(url, method, path, body, timeout,
                                    key=key, hedge=hedge,
                                    ranked=ranked,
                                    parent_sp=parent_sp, info=info)
                if out is not None:
                    return out
            # every live worker failed or is cooling down. Cooldowns
            # are re-read AFTER the attempts: a shed observed this
            # pass just started one, and a short Retry-After inside
            # the request's wait budget is worth sleeping out rather
            # than shedding back to the client (whose header-level
            # backoff is a full second at minimum).
            cooling = [self.tracker.cooling_s(u, key) for u in ranked]
            positive = [c for c in cooling if c > 0.0]
            soonest = min(positive) if positive else None
            now = time.time()
            if soonest is None or now + soonest >= t_end:
                break
            self._count("retries_total", "cooldown_wait")
            wsp = _otrace.open_span(parent_sp, "cooldown_wait",
                                    soonest_s=round(soonest, 3))
            time.sleep(min(soonest + 0.01, max(t_end - now, 0.0)))
            _otrace.close_span(wsp)
        self._count("exhausted_total")
        if parent_sp is not None:
            parent_sp.set(exhausted=True)
        retry_after = max(soonest or 1.0, 0.5)
        return 503, {"Retry-After": str(max(1, int(retry_after + 1)))}, \
            json.dumps({
                "error": "no fleet worker accepted the request",
                "reason": "fleet_exhausted",
                "retry_after_s": round(retry_after, 3),
            }).encode()

    def _attempt(self, url: str, method: str, path: str,
                 body: bytes | None, timeout: float, *, key,
                 hedge: bool, ranked: list[str],
                 parent_sp=None,
                 info: dict | None = None,
                 ) -> tuple[int, dict, bytes] | None:
        """One (possibly hedged) upstream attempt; None = try the next
        worker."""
        if hedge and self.hedge_budget > 0:
            # the hedge target must itself be routable RIGHT NOW: not
            # the primary, not inside a Retry-After cooldown, and
            # ranked after the primary (a just-failed earlier worker
            # never becomes the duplicate's target)
            nxt = [u for u in ranked[ranked.index(url) + 1:]
                   if self.tracker.cooling_s(u, key) <= 0.0]
            if nxt:
                return self._attempt_hedged(url, nxt[0], method, path,
                                            body, timeout, key=key,
                                            parent_sp=parent_sp,
                                            info=info)
        return self._attempt_one(url, method, path, body, timeout,
                                 key=key, parent_sp=parent_sp,
                                 info=info)

    def _attempt_one(self, url: str, method: str, path: str,
                     body: bytes | None, timeout: float,
                     *, key, parent_sp=None, hedge: bool = False,
                     info: dict | None = None, span=None,
                     ) -> tuple[int, dict, bytes] | None:
        sp = span if span is not None else _otrace.open_span(
            parent_sp, "attempt", worker=url, hedge=hedge)
        inject_headers = None
        if sp is not None:
            if info is not None:
                # recorded at LAUNCH, not at success: a failed primary
                # and its winning hedge must BOTH be attributable
                info["hedge_span_id" if hedge
                     else "primary_span_id"] = sp.sid()
            # causal propagation (KAO111): the worker-side solve trace
            # roots under exactly THIS attempt span
            tp = _otrace.inject(sp.trace.trace_id, sp.sid())
            if tp:
                inject_headers = {_otrace.TRACEPARENT: tp}
        try:
            status, headers, data = self._proxy_once(
                url, method, path, body, timeout,
                headers=inject_headers,
            )
        except Exception as e:
            self.tracker.note_result(url, ok=False)
            self._count("retries_total", "connect_fail")
            _otrace.close_span(sp, error=repr(e)[:200])
            return None
        self.tracker.note_result(url, ok=True)
        shed = self._shed_info(status, headers, data)
        if shed is not None:
            retry_after, bucket = shed
            self.tracker.note_retry_after(
                url, retry_after,
                bucket=bucket if bucket is not None else None,
            )
            self._count("retries_total", "shed")
            _otrace.close_span(sp, status=status, shed=True,
                               retry_after_s=round(retry_after, 3))
            return None
        self._count("proxied_total")
        if info is not None:
            info["worker"] = url
            wid = headers.get("X-KAO-Worker")
            if wid:
                info["worker_identity"] = wid
            info["answered_by_hedge"] = hedge
        _otrace.close_span(sp, status=status)
        return status, headers, data

    def _attempt_hedged(self, primary: str, secondary: str,
                        method: str, path: str, body: bytes | None,
                        timeout: float, *, key, parent_sp=None,
                        info: dict | None = None,
                        ) -> tuple[int, dict, bytes] | None:
        """Race ``primary`` against a delayed duplicate on
        ``secondary``: fire the duplicate only after ``hedge_s``
        without an answer and only inside the concurrent-hedge budget.
        First non-shed answer wins; the loser's work is the budgeted
        cost of the tail latency saved."""
        results: list = []
        done = threading.Condition()
        # per-slot attribution scratch: the racing threads never write
        # one shared dict (the loser finishing late must not overwrite
        # the winner's attribution); the winner's entry merges below
        infos: list[dict] = [{}, {}]

        def run(u, slot, span, hedge=False, release_token=False):
            try:
                out = self._attempt_one(u, method, path, body,
                                        timeout, key=key,
                                        parent_sp=parent_sp,
                                        hedge=hedge, info=infos[slot],
                                        span=span)
            finally:
                if release_token:
                    # the duplicate's budget token is held for as long
                    # as the duplicate actually occupies a worker, not
                    # just until the race resolves
                    with self._lock:
                        self._hedges_inflight -= 1
            with done:
                results.append((slot, out))
                done.notify_all()

        def launch(u, slot, hedge=False, release_token=False):
            # open the attempt span (and stamp its ID into the slot's
            # attribution scratch) BEFORE Thread.start(): the winner's
            # merge below may run before the OS ever schedules the
            # loser's thread, and the envelope must still carry both
            # attempt span IDs
            sp = _otrace.open_span(parent_sp, "attempt", worker=u,
                                   hedge=hedge)
            if sp is not None:
                infos[slot]["hedge_span_id" if hedge
                            else "primary_span_id"] = sp.sid()
            threading.Thread(
                target=run, args=(u, slot, sp),
                kwargs={"hedge": hedge,
                        "release_token": release_token},
                daemon=True,
            ).start()

        launch(primary, 0)
        launched = 1
        hedged = False
        with done:
            done.wait(self.hedge_s)
            if not results:
                with self._lock:
                    can = self._hedges_inflight < self.hedge_budget
                    if can:
                        self._hedges_inflight += 1
                if can:
                    self._count("hedges_total")
                    hedged = True
                    if parent_sp is not None:
                        # the duplicate race is itself a tail-retention
                        # signal (TailPolicy keeps hedged traces full)
                        parent_sp.set(hedged=True)
                        _otrace.close_span(_otrace.open_span(
                            parent_sp, "hedge_launch",
                            secondary=secondary,
                        ))
                    launch(secondary, 1, hedge=True,
                           release_token=True)
                    launched = 2

            def merge_attribution(slot: int) -> None:
                if info is None:
                    return
                if "primary_span_id" in infos[0]:
                    info["primary_span_id"] = infos[0][
                        "primary_span_id"]
                if "hedge_span_id" in infos[1]:
                    info["hedge_span_id"] = infos[1]["hedge_span_id"]
                for k in ("worker", "worker_identity",
                          "answered_by_hedge"):
                    if k in infos[slot]:
                        info[k] = infos[slot][k]
                if hedged:
                    info["hedge_won"] = (slot == 1)

            while True:
                for slot, out in results:
                    if out is not None:
                        if slot == 1:
                            self._count("hedge_wins_total")
                        merge_attribution(slot)
                        if hedged and parent_sp is not None:
                            parent_sp.set(hedge_won=(slot == 1))
                        return out
                if len(results) >= launched:
                    # every launched attempt failed: merge NOTHING —
                    # route() fails over, and a later worker's
                    # successful plain attempt must not inherit this
                    # dead race's hedge_span_id/hedge_won
                    return None
                done.wait()

    # -- warmup orchestration ----------------------------------------

    @staticmethod
    def _parse_shape(sh) -> tuple[int, int, int, int]:
        if isinstance(sh, dict):
            vals = (sh.get("brokers"), sh.get("partitions"),
                    sh.get("rf", 3), sh.get("racks", 1))
        elif isinstance(sh, list) and 2 <= len(sh) <= 4:
            vals = tuple(sh) + (3, 1)[len(sh) - 2:]
        else:
            raise ValueError(
                "each warmup shape must be {brokers, partitions, rf?, "
                "racks?} or a [brokers, partitions, rf?, racks?] array"
            )
        if not all(isinstance(v, int) and not isinstance(v, bool)
                   and v > 0 for v in vals):
            raise ValueError(
                f"warmup shape values must be positive ints: {sh}"
            )
        return vals  # (B, P, R, K)

    def orchestrate_warmup(self, payload: dict) -> tuple[int, dict]:
        """POST /warmup at the router: partition the shapes by bucket
        owner (each bucket compiles exactly once fleet-wide), then
        optionally spread every bucket to every other worker from the
        shared persistent compile cache."""
        if not isinstance(payload, dict):
            return 400, {"error": "request body must be a JSON object"}
        shapes = payload.get("shapes")
        if not isinstance(shapes, list) or not shapes:
            return 400, {"error": "missing required field 'shapes' "
                                  "(non-empty list)"}
        spread = payload.get("spread", "all")
        if spread not in ("all", "owners"):
            return 400, {"error": "warmup 'spread' must be 'all' "
                                  "(every worker ends warm; non-owners "
                                  "pull from the shared compile cache) "
                                  "or 'owners'"}
        try:
            parsed = [self._parse_shape(sh) for sh in shapes]
        except ValueError as e:
            return 400, {"error": str(e)}
        passthrough = {
            k: payload[k]
            for k in ("engine", "lanes", "portfolio")
            if k in payload
        }
        live = self.tracker.live()
        if not live:
            return 503, {"error": "no live workers to warm",
                         "reason": "fleet_exhausted",
                         "retry_after_s": 5.0}
        self._count("warmups_total")
        owned: dict[str, list] = {}
        for b, p, r, k in parsed:
            key = _aff.shape_key(b, p, r, k)
            owner = _aff.rendezvous_rank(key, live)[0]
            owned.setdefault(owner, []).append(
                {"brokers": b, "partitions": p, "rf": r, "racks": k}
            )

        def post_warmup(url, shs):
            body = json.dumps(
                {"shapes": shs, **passthrough}
            ).encode()
            try:
                status, _, data = self._proxy_once(
                    url, "POST", "/warmup", body,
                    self.solve_timeout_s,
                )
                self.tracker.note_result(url, ok=True)
                out = json.loads(data)
                if status != 200:
                    return {"error": out.get("error",
                                             f"status {status}")}
                return out
            except Exception as e:
                self.tracker.note_result(url, ok=False)
                return {"error": repr(e)[:200]}

        def phase(assignments: dict[str, list]) -> dict:
            threads, results = [], {}

            def run(u, shs):
                results[u] = post_warmup(u, shs)

            for u, shs in assignments.items():
                t = threading.Thread(target=run, args=(u, shs),
                                     daemon=True)
                t.start()
                threads.append(t)
            for t in threads:
                t.join()
            return results

        phase1 = phase(owned)
        phase2: dict = {}
        if spread == "all" and len(live) > 1:
            spread_assign = {
                u: [sh for ow, shs in owned.items() if ow != u
                    for sh in shs]
                for u in live
            }
            spread_assign = {u: shs for u, shs in spread_assign.items()
                            if shs}
            phase2 = phase(spread_assign)

        def misses(rows: dict) -> int | None:
            """Summed persistent-cache misses across a phase — None
            when ANY worker in the phase errored: a failed spread must
            read as unproven (consumers compare against 0, and
            None != 0), never as a vacuously perfect shared-cache
            spread."""
            n = 0
            for out in rows.values():
                if "error" in out:
                    return None
                for row in (out.get("warmed") or []):
                    n += int((row.get("persistent") or {})
                             .get("misses") or 0)
            return n

        errors = {
            u: out["error"]
            for u, out in {**phase1, **phase2}.items()
            if "error" in out
        }
        return 200, {
            "workers": len(live),
            "partition": owned,
            "phase1": phase1,
            "phase2": phase2,
            # each bucket should compile exactly once fleet-wide:
            # phase-1 misses are those single cold compiles, phase-2
            # misses should be ZERO with the shared cache armed (and
            # null — not zero — if the phase itself failed anywhere)
            "fresh_compiles": misses(phase1),
            "spread_fresh_compiles": misses(phase2),
            **({"errors": errors} if errors else {}),
        }

    # -- views -------------------------------------------------------

    def affinity_rate(self) -> float | None:
        with self._lock:
            h = self.counters["affinity_hits_total"]
            m = self.counters["affinity_misses_total"]
        return round(h / (h + m), 4) if (h + m) else None

    def snapshot(self) -> dict:
        with self._lock:
            counters = json.loads(json.dumps(self.counters))
            inflight = self._hedges_inflight
        return {
            "status": "ok",
            "role": "router",
            "routing": {
                "affinity_rate": self.affinity_rate(),
                "hedge_ms": round(self.hedge_s * 1e3, 1),
                "hedge_budget": self.hedge_budget,
                "hedges_inflight": inflight,
                "lock_wait_s": self.lock_wait_s,
            },
            "counters": counters,
            "fleet": self.tracker.snapshot(),
        }


def render_router_metrics(router: Router) -> str:
    """The ``kao_router_*`` families (docs/FLEET.md), rendered through
    the shared exposition helpers so the shape matches every other
    surface (KAO107)."""
    snap = router.snapshot()
    c = snap["counters"]
    fleet = snap["fleet"]
    rate = snap["routing"]["affinity_rate"]
    fams = [
        ("kao_router_requests_total", "counter",
         "requests received by the router, by route",
         [({"route": r}, n)
          for r, n in sorted(c["requests_total"].items())]),
        ("kao_router_affinity_hits_total", "counter",
         "keyed requests whose first-ranked worker held the bucket "
         "warm",
         [(None, c["affinity_hits_total"])]),
        ("kao_router_affinity_misses_total", "counter",
         "keyed requests routed to a cold worker",
         [(None, c["affinity_misses_total"])]),
        ("kao_router_affinity_unkeyed_total", "counter",
         "requests with no computable bucket key",
         [(None, c["affinity_unkeyed_total"])]),
        ("kao_router_affinity_rate", "gauge",
         "affinity hit fraction over keyed requests (-1 before the "
         "first keyed request)",
         [(None, -1.0 if rate is None else rate)]),
        ("kao_router_retries_total", "counter",
         "failover attempts, by reason",
         [({"reason": r}, n)
          for r, n in sorted(c["retries_total"].items())]),
        ("kao_router_hedges_total", "counter",
         "duplicate requests fired after the hedge window",
         [(None, c["hedges_total"])]),
        ("kao_router_hedge_wins_total", "counter",
         "hedged duplicates that answered first",
         [(None, c["hedge_wins_total"])]),
        ("kao_router_sticky_total", "counter",
         "cluster-sticky routed requests (one writer per cluster)",
         [(None, c["sticky_total"])]),
        ("kao_router_exhausted_total", "counter",
         "router-originated 503s (every worker shed or unreachable)",
         [(None, c["exhausted_total"])]),
        ("kao_router_warmups_total", "counter",
         "fleet warmup orchestrations",
         [(None, c["warmups_total"])]),
        ("kao_router_proxied_total", "counter",
         "upstream responses relayed to clients",
         [(None, c["proxied_total"])]),
        ("kao_router_workers", "gauge",
         "workers currently live in the routing set",
         [(None, len(fleet["live"]))]),
        ("kao_router_worker_up", "gauge",
         "per-worker liveness (1 = in the routing set)",
         [({"worker": u}, 1 if w["alive"] else 0)
          for u, w in sorted(fleet["workers"].items())]),
        ("kao_router_worker_warm_buckets", "gauge",
         "per-worker warm-bucket ledger size",
         [({"worker": u}, len(w["warm_buckets"]))
          for u, w in sorted(fleet["workers"].items())]),
        ("kao_router_trace_reports", "gauge",
         "route traces resident in the router's ring (the fleet "
         "trace store behind GET /debug/traces)",
         [(None, _otrace.RECENT.stats()["reports"])]),
    ]
    # the shared kao_trace_* families (tail retention + traceparent
    # codec traffic) — same shape the workers render
    fams.extend(_otrace.trace_families())
    return _expo.render(fams)


# --------------------------------------------------------------------------
# the HTTP shell
# --------------------------------------------------------------------------


class RouterHandler(BaseHTTPRequestHandler):
    server_version = "kao-router/1.0"

    @property
    def router(self) -> Router:
        return self.server.router

    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _send_json(self, status: int, obj: dict,
                   headers: dict | None = None) -> None:
        body = json.dumps(obj, default=str).encode()
        self._send_raw(status, {"Content-Type": "application/json",
                                **(headers or {})}, body)

    def _send_raw(self, status: int, headers: dict,
                  body: bytes) -> None:
        self.send_response(status)
        # hop-by-hop headers are this hop's business, and Server/Date
        # are re-stamped by send_response — relaying the upstream's
        # copies would duplicate them
        hop = {"content-length", "connection", "transfer-encoding",
               "keep-alive", "server", "date"}
        for k, v in headers.items():
            if k.lower() not in hop:
                self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _relay(self, out: tuple[int, dict, bytes]) -> None:
        status, headers, body = out
        self._send_raw(status, headers, body)

    def _body(self) -> bytes | None:
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            return None
        if n < 0 or n > MAX_BODY_BYTES:
            return None
        return self.rfile.read(n)

    def _route(self) -> str:
        return self.path.split("?", 1)[0].rstrip("/") or "/"

    def _trace_begin(self, name: str, **attrs):
        """Begin the request's causal trace: adopt a client-supplied
        ``traceparent`` (remote-parented root) or open a fresh root.
        Returns ``(trace, remote_ctx)`` — ``(None, None)`` when router
        tracing is off (--no-trace)."""
        if not getattr(self.server, "trace", True):
            return None, None
        ctx = _otrace.extract(self.headers.get(_otrace.TRACEPARENT))
        tr = _otrace.begin(
            ctx.trace_id if ctx else True, name=name,
            remote_parent=ctx.span_id if ctx else None, **attrs,
        )
        if tr is not None:
            # mint the root's span ID NOW, before finish() snapshots
            # the report: the traceparent echoed after the relay
            # references this ID, so it must exist in the stored tree
            tr.root.sid()
        return tr, ctx

    def _finish_trace(self, tr, out) -> None:
        if tr is not None:
            if out is not None:
                tr.root.set(status=out[0])
            _otrace.finish(tr)

    def _attribute(self, out, info: dict, tr):
        """Post-process a routed answer: merge the attribution the
        route collected — answering worker identity + both attempt
        span IDs (primary + hedge), the hedge-attribution
        contract — into a successful JSON envelope, and echo the trace
        context as a ``traceparent`` response header."""
        status, headers, data = out
        if status == 200 and info.get("worker"):
            try:
                obj = json.loads(data)
            except ValueError:
                obj = None
            if isinstance(obj, dict):
                route_info = {"worker": info["worker"]}
                for k in ("worker_identity", "primary_span_id",
                          "hedge_span_id", "answered_by_hedge",
                          "hedge_won"):
                    if info.get(k) is not None:
                        route_info[k] = info[k]
                if tr is not None:
                    route_info["trace_id"] = tr.trace_id
                obj["route"] = route_info
                data = json.dumps(obj, default=str).encode()
        if tr is not None:
            tp = _otrace.inject(tr.trace_id, tr.root.sid())
            if tp:
                headers = {**headers, _otrace.TRACEPARENT: tp}
        return status, headers, data

    def _routed(self, name: str, fn, info: dict | None = None,
                **attrs) -> None:
        """Run one route() call under a request trace and relay its
        (attributed) answer."""
        tr, _ = self._trace_begin(name, **attrs)
        out = None
        try:
            out = fn()
        finally:
            self._finish_trace(tr, out)
        self._relay(self._attribute(out, info or {}, tr))

    def do_GET(self):
        route = self._route()
        r = self.router
        if route == "/healthz":
            self._send_json(200, r.snapshot())
        elif route == "/metrics":
            self._send_raw(
                200, {"Content-Type": "text/plain; version=0.0.4"},
                render_router_metrics(r).encode(),
            )
        elif route == "/":
            self._send_json(200, {
                "service": "kao-router",
                "doc": "docs/FLEET.md",
                "workers": r.tracker.urls(),
                "proxies": ["/submit", "/evaluate", "/warmup",
                            "/clusters/*"],
                "debug": ["/debug/traces", "/debug/traces/<id>"],
            })
        elif route == "/clusters":
            r._count("requests_total", "clusters_get")
            self._merge_cluster_listing()
        elif route == "/debug/traces":
            r._count("requests_total", "debug_traces")
            self._send_json(200, {"trace_ids": _otrace.RECENT.ids()})
        elif route.startswith("/debug/traces/"):
            r._count("requests_total", "debug_traces")
            self._merged_trace(route[len("/debug/traces/"):])
        elif route.startswith("/clusters/"):
            cid = route[len("/clusters/"):].split("/", 1)[0]
            r._count("requests_total", "clusters_get")
            r._count("sticky_total")
            self._routed(
                "route",
                lambda: r.route("GET", self.path, None, sticky=cid,
                                timeout=r.connect_timeout_s * 6),
                route="clusters_get", cluster=cid,
            )
        else:
            self._send_json(404, {
                "error": f"no such router endpoint: {self.path}; "
                         "worker debug surfaces are per-worker "
                         "(see /healthz fleet.workers)",
            })

    def _merged_trace(self, trace_id: str) -> None:
        """GET /debug/traces/<id> — the cross-process causal join
        (docs/OBSERVABILITY.md "Distributed traces"): the router's own
        route trace plus every live worker's /debug/solves/<id> tree
        for the same ID, unioned under the router's root
        (obs.causal.merge_fleet_trace). ``?format=chrome`` exports the
        merged tree as ONE Perfetto file with per-process track
        groups."""
        r = self.router
        own = _otrace.RECENT.get(trace_id)
        remotes, errors = _ocausal.collect_remote(
            r.tracker.live(), trace_id,
            timeout_s=r.connect_timeout_s * 6,
        )
        if own is None and not remotes:
            self._send_json(404, {
                "error": f"no trace {trace_id!r} on the router or any "
                         "live worker (rings hold recent traces only; "
                         "with KAO_TRACE_TAIL a fast-clean trace may "
                         "have been head-sampled away)",
                **({"errors": errors} if errors else {}),
            })
            return
        merged = _ocausal.merge_fleet_trace(trace_id, own, remotes)
        if errors:
            merged["errors"] = errors
        fmt = (urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query,
        ).get("format") or ["json"])[0]
        if fmt == "chrome":
            self._send_json(200, _ochrome.to_chrome_fleet(merged))
        elif fmt == "json":
            self._send_json(200, merged)
        else:
            self._send_json(400, {
                "error": f"unknown format {fmt!r}; want 'json' or "
                         "'chrome'",
            })

    def _merge_cluster_listing(self) -> None:
        """GET /clusters fans out to every live worker CONCURRENTLY —
        N dead workers cost ~one connect timeout on this handler
        thread, not N stacked (the /debug/fleet discipline) — and
        unions the cluster maps (each cluster lives on exactly one
        sticky owner)."""
        r = self.router
        merged: dict = {}
        errors: dict = {}
        lock = threading.Lock()

        def fetch(url):
            try:
                status, _, data = r._proxy_once(
                    url, "GET", "/clusters", None,
                    r.connect_timeout_s * 6,
                )
                r.tracker.note_result(url, ok=True)
                if status == 200:
                    body = json.loads(data)
                    with lock:
                        for cid, info in (body.get("clusters")
                                          or {}).items():
                            merged[cid] = {**info, "worker": url}
                else:
                    with lock:
                        errors[url] = f"status {status}"
            except Exception as e:
                r.tracker.note_result(url, ok=False)
                with lock:
                    errors[url] = repr(e)[:200]

        threads = [threading.Thread(target=fetch, args=(u,),
                                    daemon=True)
                   for u in r.tracker.live()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._send_json(200, {
            "clusters": merged,
            **({"errors": errors} if errors else {}),
        })

    def do_POST(self):
        route = self._route()
        r = self.router
        body = self._body()
        if body is None:
            self._send_json(400, {"error": "bad Content-Length"})
            return
        if route == "/submit":
            r._count("requests_total", "submit")
            try:
                payload = json.loads(body)
            except ValueError:
                payload = None
            key = (_aff.bucket_key_of(payload)
                   if isinstance(payload, dict) else None)
            hedge = bool(
                isinstance(payload, dict)
                and payload.get("deadline_s") is not None
            )
            info: dict = {}
            self._routed(
                "route",
                lambda: r.route("POST", "/submit", body, key=key,
                                hedge=hedge, info=info),
                info=info, route="submit",
            )
        elif route == "/evaluate":
            r._count("requests_total", "evaluate")
            self._routed(
                "route",
                lambda: r.route("POST", "/evaluate", body),
                route="evaluate",
            )
        elif route == "/warmup":
            r._count("requests_total", "warmup")
            try:
                payload = json.loads(body)
            except ValueError:
                self._send_json(400, {"error": "invalid JSON"})
                return
            status, out = r.orchestrate_warmup(payload)
            self._send_json(status, out)
        elif route.startswith("/clusters/"):
            cid = route[len("/clusters/"):].split("/", 1)[0]
            r._count("requests_total", "clusters_post")
            r._count("sticky_total")
            # sticky + sequential: epoch fencing must see ONE writer
            # per cluster, so cluster commands never hedge in parallel
            self._routed(
                "route",
                lambda: r.route("POST", self.path, body, sticky=cid),
                route="clusters_post", cluster=cid,
            )
        else:
            self._send_json(404,
                            {"error": f"no such endpoint: {self.path}"})


def make_router_server(host: str, port: int, router: Router, *,
                       verbose: bool = False,
                       trace: bool = True) -> ThreadingHTTPServer:
    srv = ThreadingHTTPServer((host, port), RouterHandler)
    srv.router = router
    srv.verbose = verbose
    srv.trace = trace
    return srv


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kao-router",
        description="Bucket-affinity fleet router: proxy /submit, "
                    "/clusters/*, /evaluate and /warmup across N "
                    "serve workers with warmth-first routing, hedged "
                    "failover, and fleet warmup orchestration "
                    "(docs/FLEET.md)",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--workers", required=True, metavar="URL,URL",
                    help="worker base URLs, e.g. "
                         "'http://10.0.0.2:8787,http://10.0.0.3:8787'")
    ap.add_argument("--health-interval-s", type=float, default=2.0,
                    help="worker /healthz poll interval (liveness + "
                         "the warm-bucket affinity ledger)")
    ap.add_argument("--fail-after", type=int, default=2,
                    help="consecutive failures before a worker leaves "
                         "the routing set (rejoins on first success)")
    ap.add_argument("--lock-wait-s", type=float,
                    default=DEFAULT_LOCK_WAIT_S,
                    help="max seconds a request may spend in failover "
                         "(incl. waiting out worker Retry-After "
                         "cooldowns) before the router sheds 503")
    ap.add_argument("--solve-timeout-s", type=float,
                    default=DEFAULT_SOLVE_TIMEOUT_S,
                    help="per-attempt upstream read timeout")
    ap.add_argument("--connect-timeout-s", type=float,
                    default=DEFAULT_CONNECT_TIMEOUT_S,
                    help="health-poll/listing timeout")
    ap.add_argument("--hedge-ms", type=float, default=DEFAULT_HEDGE_MS,
                    help="latency hedge: a deadline-carrying /submit "
                         "unanswered after this window fires a "
                         "duplicate at the next-ranked worker (first "
                         "answer wins)")
    ap.add_argument("--hedge-budget", type=int,
                    default=DEFAULT_HEDGE_BUDGET,
                    help="max concurrent hedged duplicates fleet-wide "
                         "(0 disables hedging)")
    ap.add_argument("--no-trace", action="store_true",
                    help="disable per-request causal traces (route "
                         "decisions, attempts, hedges; responses then "
                         "carry no traceparent and /debug/traces "
                         "stays empty on the router). Tail retention "
                         "on the router's ring is the same "
                         "KAO_TRACE_TAIL env the workers honor "
                         "(docs/OBSERVABILITY.md)")
    ap.add_argument("--verbose", action="store_true",
                    help="access logs")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    urls = [u.strip().rstrip("/") for u in args.workers.split(",")
            if u.strip()]
    bad = [u for u in urls
           if not u.startswith(("http://", "https://"))]
    if bad or not urls:
        build_parser().error(
            f"--workers URLs must be http(s)://: {bad or urls}"
        )
    tracker = FleetTracker(
        urls, interval_s=args.health_interval_s,
        timeout_s=args.connect_timeout_s, fail_after=args.fail_after,
    )
    router = Router(
        tracker, lock_wait_s=args.lock_wait_s,
        solve_timeout_s=args.solve_timeout_s,
        connect_timeout_s=args.connect_timeout_s,
        hedge_ms=args.hedge_ms, hedge_budget=args.hedge_budget,
    )
    tracker.start()
    srv = make_router_server(args.host, args.port, router,
                             verbose=args.verbose,
                             trace=not args.no_trace)
    _olog.log("router_listening", host=args.host,
              port=srv.server_address[1], workers=len(urls))
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        tracker.stop()
        srv.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
