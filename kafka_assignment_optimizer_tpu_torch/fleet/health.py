"""Fleet worker tracking for the router (docs/FLEET.md).

One background thread polls every worker's ``/healthz`` on an interval
and keeps, per worker:

- **liveness** — a worker is live until ``fail_after`` consecutive
  probe/proxy failures, and rejoins on the first success (the router
  also feeds it in-band results via :meth:`FleetTracker.note_result`,
  so a SIGKILL'd worker leaves the routing set at the first failed
  proxy, not a poll interval later);
- **the warmth ledger** — the ``cache.warm_buckets`` affinity ledger
  (bucket keys the worker has solved) plus the lane-executable view,
  feeding the router's warm-first ranking;
- **cooldowns** — ``Retry-After`` promises the worker made on 503
  sheds, scoped worker-wide (queue_full and friends) or per bucket
  (circuit_open carries its bucket in the shed body), so the router
  honors the backoff contract per worker while other workers absorb
  the traffic.

The tracker never imports torch and tolerates any worker response shape:
a peer running an older build simply reports no ledger and gets pure
rendezvous routing.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request

from ..obs import log as _olog

__all__ = ["WorkerState", "FleetTracker"]

DEFAULT_INTERVAL_S = 2.0
DEFAULT_TIMEOUT_S = 5.0
DEFAULT_FAIL_AFTER = 2


class WorkerState:
    """One worker's live view. All mutation happens under the owning
    tracker's lock."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.alive = True  # optimistic: route until proven dead
        self.fails = 0
        self.polls = 0
        self.last_ok: float | None = None
        self.warm: set = set()
        self.queue: dict = {}
        self.persistent: dict = {}
        self.identity: dict = {}
        # scope -> unix ts before which this worker must not be sent
        # that scope's traffic; scope None = worker-wide
        self.cooldown: dict = {}

    def cooling_s(self, key, now: float) -> float:
        """Seconds this worker is still honoring a Retry-After for
        ``key`` (bucket tuple or None); 0.0 = ready."""
        until = max(self.cooldown.get(None, 0.0),
                    self.cooldown.get(key, 0.0) if key is not None
                    else 0.0)
        return max(until - now, 0.0)

    def view(self, now: float) -> dict:
        return {
            "url": self.url,
            "alive": self.alive,
            "fails": self.fails,
            "polls": self.polls,
            "age_s": (round(now - self.last_ok, 3)
                      if self.last_ok else None),
            "warm_buckets": sorted(list(k) for k in self.warm),
            "queue": self.queue,
            "persistent_cache": self.persistent,
            "cooldowns": {
                str(k): round(v - now, 3)
                for k, v in self.cooldown.items() if v > now
            },
        }


class FleetTracker:
    """Polls workers' ``/healthz`` and serves the router's routing
    inputs. ``fetch`` is injectable (url -> healthz dict) so tests
    drive membership and warmth without sockets."""

    def __init__(self, urls: list[str], *,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 fail_after: int = DEFAULT_FAIL_AFTER,
                 fetch=None):
        self._lock = threading.Lock()  # kao: guards(_workers, polls_total, poll_errors_total, _thread)
        self._workers = {u.rstrip("/"): WorkerState(u)
                         for u in urls}
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.fail_after = max(1, int(fail_after))
        self._fetch = fetch or self._fetch_http
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.polls_total = 0
        self.poll_errors_total = 0

    # -- membership --------------------------------------------------

    def urls(self) -> list[str]:
        with self._lock:
            return list(self._workers)

    def live(self) -> list[str]:
        """Workers currently routable. When EVERY worker looks dead,
        all of them come back — a wrong 'all dead' verdict (a router-
        side network blip) must degrade to trying anyway, not to
        refusing every request."""
        with self._lock:
            up = [u for u, w in self._workers.items() if w.alive]
            return up or list(self._workers)

    def warm_map(self) -> dict:
        with self._lock:
            return {u: set(w.warm) for u, w in self._workers.items()}

    def state(self, url: str) -> WorkerState | None:
        with self._lock:
            return self._workers.get(url.rstrip("/"))

    # -- in-band evidence from the proxy path ------------------------

    def note_result(self, url: str, ok: bool) -> None:
        """The router reports each proxy attempt: a failure is
        evidence as strong as a failed poll (SIGKILL leaves the set at
        the first failed request), a success instantly rejoins."""
        with self._lock:
            w = self._workers.get(url.rstrip("/"))
            if w is None:
                return
            if ok:
                was_dead = not w.alive
                w.fails, w.alive, w.last_ok = 0, True, time.time()
                if was_dead:
                    _olog.log("router_worker_rejoin", worker=w.url)
            else:
                w.fails += 1
                if w.fails >= self.fail_after and w.alive:
                    w.alive = False
                    _olog.warn("router_worker_down", worker=w.url,
                               fails=w.fails)

    def note_retry_after(self, url: str, seconds: float,
                         bucket=None) -> None:
        """Record a worker's Retry-After promise: worker-wide, or
        scoped to the bucket the shed body named (circuit_open)."""
        with self._lock:
            w = self._workers.get(url.rstrip("/"))
            if w is None:
                return
            scope = tuple(bucket) if bucket is not None else None
            until = time.time() + max(float(seconds), 0.0)
            if until > w.cooldown.get(scope, 0.0):
                w.cooldown[scope] = until

    def cooling_s(self, url: str, key) -> float:
        now = time.time()
        with self._lock:
            w = self._workers.get(url.rstrip("/"))
            return w.cooling_s(key, now) if w is not None else 0.0

    # -- polling -----------------------------------------------------

    def _fetch_http(self, url: str) -> dict:
        # background liveness poll: there is no client request (and so
        # no causal context) to propagate on this hop
        # kao: disable=KAO111 -- read-only health poll, no active request
        with urllib.request.urlopen(
            f"{url}/healthz", timeout=self.timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))

    def poll_once(self) -> None:
        for url in self.urls():
            try:
                hz = self._fetch(url)
            except Exception:
                with self._lock:
                    self.polls_total += 1
                    self.poll_errors_total += 1
                self.note_result(url, ok=False)
                continue
            cache = (hz.get("cache") or {}) if isinstance(hz, dict) \
                else {}
            warm = {
                tuple(int(x) for x in k)
                for k in (cache.get("warm_buckets") or [])
                if isinstance(k, (list, tuple))
            }
            with self._lock:
                self.polls_total += 1
                w = self._workers.get(url)
                if w is None:
                    continue
                w.polls += 1
                w.warm = warm
                w.queue = hz.get("queue") or {}
                w.persistent = cache.get("persistent_cache") or {}
                obs = hz.get("observability") or {}
                w.identity = obs.get("worker") or {}
            self.note_result(url, ok=True)

    def start(self) -> None:
        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.poll_once()
                except Exception:  # pragma: no cover - belt only
                    pass

        # check-and-reserve UNDER the lock (KAO116): two racing
        # start() calls both saw None here and spawned two pollers —
        # double poll traffic and double-counted polls_total forever
        with self._lock:
            if self._thread is not None:
                return
            self._thread = thread = threading.Thread(
                target=run, daemon=True, name="kao-router-health",
            )
        # prime OUTSIDE the lock: the synchronous first poll is an
        # HTTP round-trip per worker and must not convoy the routing
        # reads (KAO117's blocking-under-lock class)
        self.poll_once()  # prime synchronously so boot routes warm
        thread.start()

    def stop(self) -> None:
        self._stop.set()

    def snapshot(self) -> dict:
        now = time.time()
        with self._lock:
            return {
                "workers": {
                    u: w.view(now) for u, w in self._workers.items()
                },
                "live": [u for u, w in self._workers.items()
                         if w.alive],
                "polls_total": self.polls_total,
                "poll_errors_total": self.poll_errors_total,
                "interval_s": self.interval_s,
            }
