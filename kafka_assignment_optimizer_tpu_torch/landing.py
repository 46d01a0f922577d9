"""Service front door — the human-usable landing page (``GET /``).

A copy of the reference package's ``landing``: the upstream project
hosts a public instance with a usage/extended-example page in front of
its ``POST /submit`` endpoint, and this is that surface. The page and
the schema are the reference's byte for byte, so a client sees the same
front door whichever package serves it. Self-contained HTML (no external assets), prefilled with the
reference's worked demo (``README.md:27-91``: 20 brokers across two AZs,
one 10-partition RF=2 topic, decommission broker 19 — optimal plan moves
exactly one replica), plus a machine-readable request schema at
``GET /schema`` for clients that negotiate JSON.
"""

from __future__ import annotations

import json

# The reference README's worked demo (README.md:52-63): prefills the form
# so a first-time visitor can press "Optimize" and see the 1-move optimum.
DEMO_ASSIGNMENT = {
    "version": 1,
    "partitions": [
        {"topic": "x.y.z.t", "partition": 0, "replicas": [7, 18]},
        {"topic": "x.y.z.t", "partition": 1, "replicas": [8, 19]},
        {"topic": "x.y.z.t", "partition": 2, "replicas": [9, 10]},
        {"topic": "x.y.z.t", "partition": 3, "replicas": [0, 11]},
        {"topic": "x.y.z.t", "partition": 4, "replicas": [1, 12]},
        {"topic": "x.y.z.t", "partition": 5, "replicas": [2, 13]},
        {"topic": "x.y.z.t", "partition": 6, "replicas": [3, 14]},
        {"topic": "x.y.z.t", "partition": 7, "replicas": [4, 15]},
        {"topic": "x.y.z.t", "partition": 8, "replicas": [5, 16]},
        {"topic": "x.y.z.t", "partition": 9, "replicas": [6, 17]},
    ],
}


def request_schema() -> dict:
    """Machine-readable request/response shapes (``GET /schema``)."""
    return {
        "service": "kafka-assignment-optimizer-tpu",
        "endpoints": {
            "POST /submit": {
                "request": {
                    "assignment": "reassignment JSON object (required): "
                                  "{version, partitions: [{topic, "
                                  "partition, replicas: [brokerId, ...]}]}",
                    "brokers": "target broker list (required): "
                               "[0, 1, ...] or a range string like '0-18'",
                    "topology": "broker->rack object {'0': 'rackA', ...}, "
                                "'even-odd', or null (single rack)",
                    "rf": "target replication factor: int, "
                          "{topic: int}, or null (keep current)",
                    "solver": "'auto' | 'tpu' | 'milp' | 'native' | "
                              "'lp_solve'",
                    "options": "search knobs: seed, batch, rounds, sweeps, "
                               "steps_per_round, engine, time_limit_s, "
                               "t_hi, t_lo, n_devices",
                    "deadline_s": "optional per-request end-to-end "
                                  "deadline in seconds (queue wait + "
                                  "solve; docs/RESILIENCE.md); expired "
                                  "requests shed with 503 + Retry-After",
                },
                "response": {
                    "assignment": "the optimized reassignment JSON "
                                  "(leader = replicas[0])",
                    "report": "moves, leader changes, feasibility, "
                              "objective weight vs provable upper bound, "
                              "proven_optimal, timings",
                },
            },
            "POST /evaluate": {
                "request": "same as /submit minus solver/options, plus "
                           "'plan': the reassignment JSON to audit",
                "response": "feasibility + per-constraint violation "
                            "counts, replica moves vs the provable "
                            "minimum, objective weight vs its provable "
                            "upper bound, proven_optimal",
            },
            "POST /warmup": {
                "request": "{'shapes': [{'brokers', 'partitions', "
                           "'rf'?, 'racks'?}, ...], 'engine'?: "
                           "'sweep'|'chain', 'lanes'?: bool} — "
                           "precompile executables for these cluster "
                           "shapes (docs/BUCKETING.md), including the "
                           "consolidated lane-padded batch executable "
                           "once per bucket unless lanes=false "
                           "(docs/CONSTRUCTOR.md)",
                "response": "per-shape bucket, wall clock, and compile "
                            "counters (single + lane_*); already_warm "
                            "when cached",
            },
            "POST /clusters/<id>/events": {
                "request": "ONE typed, epoch-fenced cluster change "
                           "(docs/WATCH.md): {'type': 'bootstrap' | "
                           "'broker_add' | 'broker_remove' | "
                           "'broker_drain' | 'rack_fail' | "
                           "'partition_growth' | 'rf_change', "
                           "'epoch': int, ...type fields}; bootstrap "
                           "carries assignment/brokers/topology/rf",
                "response": "200: the new certified plan, warm-started "
                            "from the cluster's previous plan; 202: "
                            "event coalesced behind an in-flight solve "
                            "(fetch GET /clusters/<id>); 409: stale or "
                            "replayed epoch (no solve runs); 503 "
                            "reason=event_storm: backpressure with "
                            "Retry-After",
            },
            "POST /clusters/<id>/rollout/{start,advance,pause,rollback}": {
                "request": {
                    "epoch": "rollout-command epoch (required): a "
                             "non-negative int, strictly greater than "
                             "the rollout's current epoch (stale -> "
                             "structured 409, store untouched)",
                    "broker_cap": "start only: per-wave transfer cap "
                                  "per broker in transfer units "
                                  "(replica copies in + out); default "
                                  "from --rollout-broker-cap",
                    "rack_cap": "start only: per-wave inbound cap per "
                                "rack; default from --rollout-rack-cap",
                    "packer": "start only: 'greedy' | 'scored' "
                              "(docs/ROLLOUT.md)",
                    "canary_ok": "advance past the canary wave only: "
                                 "true applies it and advances, false "
                                 "rolls the rollout back",
                },
                "response": {
                    "200": "the rollout view: status (planned|canary|"
                           "advancing|paused|done|rolled_back), "
                           "wave_index, per-wave transfer accounting, "
                           "and current_wave as upstream-compatible "
                           "reassignment JSON",
                    "409": "stale rollout epoch or a command the state "
                           "machine cannot accept",
                },
            },
            "GET /clusters/<id>/rollout": "the rollout record: wave "
                                          "schedule, caps, applied "
                                          "waves, replans, and the "
                                          "current wave JSON",
            "GET /clusters": "watched clusters + delta-API counters; "
                             "/clusters/<id> returns one cluster's "
                             "state, epoch, and last certified plan",
            "GET /healthz": "service status, available solvers, "
                            "platform, executable-cache + queue state",
            "GET /metrics": "Prometheus text counters (kao_*, incl. "
                            "kao_cache_*, kao_queue_*, the "
                            "kao_phase_seconds / kao_solve_seconds "
                            "histograms with exemplar trace IDs, and "
                            "the kao_slo_* burn rates)",
            "GET /debug/solves": "recent solve-trace IDs; "
                                 "/debug/solves/<trace_id> returns that "
                                 "solve's span-tree report, "
                                 "?format=chrome renders it as Chrome "
                                 "trace-event JSON for Perfetto "
                                 "(docs/OBSERVABILITY.md)",
            "GET /debug/slo": "SLO engine snapshot: per-class "
                              "objectives, multi-window burn rates, "
                              "worst-recent exemplars, drift-alarm "
                              "state, and the tail of the "
                              "flight-record stream",
            "GET /debug/stream": "flight records as newline-delimited "
                                 "JSON, live as they land "
                                 "(?follow=0&tail=N for a snapshot; "
                                 "slow clients shed their own tail, "
                                 "counted in kao_stream_dropped_total)",
            "GET /debug/fleet": "this worker's records merged with "
                                "the --fleet-peers workers: "
                                "fleet-wide burn rates, drift "
                                "alarms, per-worker lag "
                                "(docs/OBSERVABILITY.md, kao-fleet)",
            "GET /schema": "this document",
        },
        "fleet": "run N of these workers behind the kao-router front "
                 "process for bucket-affinity routing, hedged "
                 "failover, and fleet-wide warmup over a shared "
                 "KAO_COMPILE_CACHE (docs/FLEET.md); the router "
                 "proxies /submit, /evaluate, /warmup and /clusters/* "
                 "unchanged, so this schema applies behind it "
                 "verbatim",
        "example": {
            "assignment": DEMO_ASSIGNMENT,
            "brokers": "0-18",
            "topology": "even-odd",
        },
    }


def render_landing() -> str:
    """The ``GET /`` HTML page: usage, worked example, live form."""
    demo = json.dumps(DEMO_ASSIGNMENT, indent=1)
    return f"""<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>kafka-assignment-optimizer-tpu</title>
<style>
  body {{ font: 15px/1.5 system-ui, sans-serif; margin: 2rem auto;
         max-width: 60rem; padding: 0 1rem; color: #1a1a1a; }}
  h1 {{ font-size: 1.5rem; }}  h2 {{ font-size: 1.15rem; margin-top: 2rem; }}
  code, pre, textarea {{ font: 13px/1.45 ui-monospace, monospace; }}
  pre {{ background: #f6f6f4; padding: .75rem; overflow-x: auto;
        border-radius: 6px; }}
  textarea {{ width: 100%; box-sizing: border-box; min-height: 10rem; }}
  input[type=text] {{ font: 13px ui-monospace, monospace; width: 100%;
        box-sizing: border-box; }}
  label {{ display: block; margin-top: .75rem; font-weight: 600; }}
  button {{ margin: 1rem .5rem 0 0; padding: .45rem 1.1rem;
        font-size: .95rem; cursor: pointer; }}
  #out {{ white-space: pre-wrap; }}
  nav a {{ margin-right: 1rem; }}
</style>
</head>
<body>
<h1>kafka-assignment-optimizer-tpu</h1>
<p>Optimal Kafka partition reassignment: given the cluster's current
assignment, a target broker list, and a broker&rarr;rack topology, the
service computes a plan that balances replicas and leaders across racks
while <strong>provably minimizing replica moves</strong> — and reports a
global-optimality certificate when the plan meets its LP/flow bounds.</p>
<nav>
  <a href="/healthz">/healthz</a>
  <a href="/metrics">/metrics</a>
  <a href="/schema">/schema</a>
  <a href="/clusters">/clusters</a>
</nav>

<h2>API</h2>
<pre>curl -s -X POST <span class="origin">http://HOST:PORT</span>/submit \\
  -H 'Content-Type: application/json' \\
  -d '{{"assignment": {{...reassignment JSON...}},
       "brokers": "0-18", "topology": "even-odd"}}'</pre>
<p>Full request/response shapes: <a href="/schema">GET /schema</a>.
Audit an existing plan (yours or
<code>kafka-reassign-partitions</code> output) with
<code>POST /evaluate</code> — same fields plus <code>"plan"</code>.
For clusters that change over time, the delta API
(<code>POST /clusters/&lt;id&gt;/events</code>) remembers each named
cluster's last certified plan and re-solves incrementally per
epoch-fenced change event — broker add/remove/drain, rack failure,
partition growth, RF change (docs/WATCH.md). Execute a certified plan
as bandwidth-budgeted move waves with canary gating and bit-exact
rollback via
<code>POST /clusters/&lt;id&gt;/rollout/{{start,advance,pause,rollback}}</code>
(docs/ROLLOUT.md).</p>

<h2>Extended example (live)</h2>
<p>Prefilled with the worked demo: a 20-broker cluster spread over two
AZs (even brokers in <code>a</code>, odd in <code>b</code>), one topic
with 10 partitions at RF=2, decommissioning broker 19. The optimal plan
changes exactly one replica (partition&nbsp;1:
<code>[8,&thinsp;19]&nbsp;&rarr;&nbsp;[8,&thinsp;1]</code>) — where
Kafka's own tool would reshuffle nearly every partition.</p>

<label for="assignment">Current assignment (reassignment JSON)</label>
<textarea id="assignment">{demo}</textarea>
<label for="brokers">Target brokers (list or range string)</label>
<input type="text" id="brokers" value="0-18">
<label for="topology">Topology (broker&rarr;rack JSON object,
"even-odd", or blank)</label>
<input type="text" id="topology" value="even-odd">
<button id="go">Optimize (POST /submit)</button>
<button id="audit" disabled>Audit result (POST /evaluate)</button>
<h2>Result</h2>
<pre id="out">&mdash;</pre>

<script>
(function () {{
  var lastPlan = null;
  document.querySelectorAll('.origin').forEach(function (el) {{
    el.textContent = location.origin;
  }});
  function payload() {{
    var topo = document.getElementById('topology').value.trim();
    var brokers = document.getElementById('brokers').value.trim();
    var body = {{
      assignment: JSON.parse(document.getElementById('assignment').value),
      brokers: brokers[0] === '[' ? JSON.parse(brokers) : brokers,
    }};
    if (topo) body.topology = topo[0] === '{{' ? JSON.parse(topo) : topo;
    return body;
  }}
  function post(path, body) {{
    var out = document.getElementById('out');
    out.textContent = 'solving\\u2026';
    fetch(path, {{
      method: 'POST',
      headers: {{'Content-Type': 'application/json'}},
      body: JSON.stringify(body),
    }}).then(function (r) {{ return r.json(); }})
      .then(function (j) {{
        out.textContent = JSON.stringify(j, null, 1);
        if (j.assignment) {{
          lastPlan = j.assignment;
          document.getElementById('audit').disabled = false;
        }}
      }})
      .catch(function (e) {{ out.textContent = 'error: ' + e; }});
  }}
  document.getElementById('go').onclick = function () {{
    try {{ post('/submit', payload()); }}
    catch (e) {{ document.getElementById('out').textContent =
                 'bad input: ' + e; }}
  }};
  document.getElementById('audit').onclick = function () {{
    try {{
      var body = payload();
      body.plan = lastPlan;
      post('/evaluate', body);
    }} catch (e) {{ document.getElementById('out').textContent =
                    'bad input: ' + e; }}
  }};
}})();
</script>
</body>
</html>
"""
