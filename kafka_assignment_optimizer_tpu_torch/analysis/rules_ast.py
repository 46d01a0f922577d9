"""AST lint pass — the project's hazard rules in PyTorch's idiom.

Counterpart of ``kafka_assignment_optimizer_tpu.analysis.rules_ast``. The
IDs and hazard classes are the reference's; the language-general rules
(KAO100, KAO106, KAO107, KAO109, KAO111, KAO112, KAO114 and the lock
rules KAO116-KAO119 of :mod:`.concurrency`) are its code and give its
findings on the same source. The rules whose reference matchers look for
JAX idioms (``donate_argnums``, ``lax.scan`` bodies, ``jax.random``,
``jax.devices()``) look for this package's idioms instead:

- **KAO101** a sweep state read again after it was passed to a stepper
  that a ``make_*stepper_fn`` factory returned: the stepper consumed it
  and its successor is the returned state (the hazard
  ``analysis.sanitize``'s donation guard trips on at run time).
- **KAO102** two state tensors made from one ``expand`` /
  ``expand_as`` / ``broadcast_to`` base (two escapes of one view: one
  storage behind both), or an in-place write (``copy_``, ``add_``,
  ``index_put_``, item assignment) through such a view — every
  broadcast element aliases ONE storage element (the aliased-state
  bug class).
  Device path only.
- **KAO103** float64 in a device path: ``torch.float64`` /
  ``torch.double``, ``.double()``, and ``torch.as_tensor`` /
  ``torch.from_numpy`` / ``torch.tensor`` of a numpy float constructor
  with no ``dtype`` (numpy's float64 default crossing onto the device).
- **KAO104** a key of ``prng.PRNGKey`` / ``split`` / ``fold_in``
  consumed twice by ``prng.bits`` / ``randint`` without a split between:
  the streams are identical, not independent.
- **KAO105** ``if`` / ``while`` / ``bool()`` on a tensor inside a step
  that a ``make_*`` factory returns: an implicit host sync (the host
  waits for the device) in the middle of the step.
- **KAO108** chaos / resilience hooks inside a factory's step or inside
  a body run under CUDA-graph capture (``with torch.cuda.graph(...)``
  and the module functions it calls): a captured hook fires once at
  capture and never again on replay.
- **KAO110** lane-config values captured as Python scalars in a
  ``make_*`` factory: the reference's check; here the value is baked
  into the step (and into any CUDA graph the step captures).
- **KAO113** host syncs (``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``np.asarray``/``np.array`` of a bound value,
  ``torch.cuda.synchronize()``) inside the chunk step (the steps
  ``make_*stepper_fn`` factories return and the module functions they
  reach) or inside a body captured as a CUDA graph. Also the C8 hazard:
  a device-wide ``torch.cuda.synchronize()`` anywhere under
  ``solvers/tpu``, ``ops`` or ``parallel``, or in ``serve.py``, outside
  ``with _CAPTURE_LOCK`` — it fails another thread's graph capture in
  progress; the stream-level ``torch.cuda.current_stream(dev)
  .synchronize()`` (``engine._sync``) is the allowed form.
- **KAO115** under ``parallel/``: device lists from
  ``torch.cuda.device_count()`` or ``torch.device("cuda")`` frozen at
  module scope, in a default argument or in a ``make_*`` factory's
  closure (the stale-mesh bug class), and tensors created there without
  an explicit ``device=``.

All rules are stdlib-``ast`` only; precision is tuned so the port's
tree is clean (real findings fixed, deliberate exceptions carrying
justified suppressions).
"""

from __future__ import annotations

import ast
import re
from collections import deque

from .findings import Finding, apply_suppressions, parse_suppressions

# KAO102/KAO103 apply only where tensors live on the device; the host-side
# exact oracles (models/, solvers/lp*, milp) legitimately run scipy/LP
# math in float64.
DEVICE_PATH_MARKERS = ("solvers/tpu", "ops", "parallel")

# reductions whose appearance in an `if` test means a tensor is being
# branched on (torch.any(x) or x.any())
_TRACED_REDUCERS = {"any", "all", "sum", "max", "min", "prod", "mean"}
# attribute reads that are host metadata of a tensor
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "weak_type", "aval",
                 "device", "is_cuda"}

# numpy constructors whose float-literal payloads default to float64
_F64_CONSTRUCTORS = {"array", "asarray", "full", "linspace", "geomspace"}


def walk(node: ast.AST):
    """``ast.walk``'s nodes in its breadth-first order, memoized on
    ``node``, so the many rules of one lint run that walk one subtree
    pay for it once; the lists live and die with the tree."""
    got = node.__dict__.get("_kao_walk")
    if got is None:
        got, todo = [], deque([node])
        while todo:
            n = todo.popleft()
            todo.extend(children(n))
            got.append(n)
        node._kao_walk = got
    return iter(got)


def children(node: ast.AST) -> tuple:
    """``ast.iter_child_nodes``, memoized on the node."""
    kids = node.__dict__.get("_kao_kids")
    if kids is None:
        kids = node._kao_kids = tuple(ast.iter_child_nodes(node))
    return kids


def _dotted(node: ast.AST) -> list[str]:
    """``a.b.c`` -> ["a", "b", "c"]; empty when not a plain chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _has_float_literal(node: ast.AST) -> bool:
    for sub in walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, float):
            return True
    return False


def _kw(call: ast.Call, name: str) -> ast.keyword | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


class _Parents:
    def __init__(self):
        self.parent: dict[ast.AST, ast.AST] = {}

    def visit(self, tree: ast.AST) -> None:
        for node in walk(tree):
            for child in children(node):
                self.parent[child] = node


def _walk_own_scope(fn):
    """Walk a function's nodes in source order WITHOUT descending into
    nested function definitions (each nested def gets its own pass)."""
    queue = list(children(fn))
    i = 0
    while i < len(queue):
        node = queue[i]
        i += 1
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        queue.extend(children(node))



def lint_source(
    text: str, path: str, rel: str | None = None
) -> list[Finding]:
    """Lint one file's source; ``rel`` is the package-relative posix
    path used for path-scoped rules (defaults to ``path``)."""
    return lint_module(text, path, rel)[0]


def lint_module(text: str, path: str, rel: str | None = None):
    """:func:`lint_source`'s findings and the module's lock-order edges
    (for ``lint_paths``' cross-file KAO118 stitch), from one parse and
    one concurrency pass."""
    rel = (rel or path).replace("\\", "/")
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [Finding("KAO100", path, e.lineno or 1,
                        f"file does not parse: {e.msg}")], []
    parents = _Parents()
    parents.visit(tree)
    out: list[Finding] = []
    out += _rule_print(tree, path, rel)
    out += _rule_float64(tree, path, rel)
    out += _rule_metrics_help_type(tree, path)
    device_path = any(m in rel for m in DEVICE_PATH_MARKERS)
    # per-function rules, each skipped where its vocabulary never
    # appears in the text (it could not match)
    steppers, keys = "stepper_fn" in text, "prng" in text
    for fn in [n for n in walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        if steppers:
            out += _rule_stepper_reuse(fn, path)
        if device_path:
            out += _rule_expanded_base(fn, path, parents.parent)
        if keys:
            out += _rule_key_reuse(fn, path)
    out += _rule_traced_branch(tree, path)
    out += _rule_chaos_in_traced(tree, path)
    out += _rule_partition_loop(tree, path, rel)
    out += _rule_decompose_loop(tree, path, rel)
    out += _rule_lane_config_capture(tree, path)
    out += _rule_uninjected_http(tree, path, rel)
    out += _rule_step_host_sync(tree, path, rel)
    out += _rule_time_delta(tree, path, rel)
    out += _rule_mesh_devices(tree, path, rel)
    from .concurrency import analyze_module

    mc = analyze_module(tree, text, path, rel)
    out += mc.findings
    return apply_file_suppressions(out, path, text), mc.edges


def apply_file_suppressions(
    findings: list[Finding], path: str, text: str
) -> list[Finding]:
    """THE suppression gate: every rule — AST, concurrency, contracts,
    cross-file — funnels its findings through here so ``# kao:
    disable=KAOxxx -- reason`` behaves identically everywhere and a
    reason-less disable surfaces as KAO100 exactly once per line."""
    sup = parse_suppressions(text)
    return apply_suppressions(
        sorted(findings, key=lambda f: (f.line, f.rule)), path, sup)


# ---------------------------------------------------------------- KAO106

def _rule_print(tree, path, rel) -> list[Finding]:
    if rel.endswith("obs/log.py"):
        return []  # the structured logger's own emit site
    return [
        Finding("KAO106", path, n.lineno,
                "bare print(); use obs.log (structured key=value lines) "
                "or suppress where stdout IS the product")
        for n in walk(tree)
        if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Name) and n.func.id == "print"
    ]



# ---------------------------------------------------------------- KAO103

_TENSOR_FROM_HOST = {"as_tensor", "from_numpy", "tensor"}
# where a numpy constructor takes its dtype positionally
_NP_DTYPE_POS = {"array": 1, "asarray": 1, "full": 2, "linspace": 5,
                 "geomspace": 4}


def _np_float64_ctor(node: ast.AST) -> str | None:
    """The name of a numpy constructor call whose float literals take
    numpy's float64 default (``np.array([0.5, 1.0])``: no dtype, by
    keyword or position), else None."""
    if not isinstance(node, ast.Call):
        return None
    chain = _dotted(node.func)
    if not (len(chain) == 2 and chain[0] in ("np", "numpy")
            and chain[1] in _F64_CONSTRUCTORS and node.args
            and _kw(node, "dtype") is None
            and len(node.args) <= _NP_DTYPE_POS[chain[1]]):
        return None
    payload = (node.args[1] if chain[1] == "full" and len(node.args) > 1
               else node.args[0])
    return chain[1] if _has_float_literal(payload) else None


def _rule_float64(tree, path, rel) -> list[Finding]:
    if not any(m in rel for m in DEVICE_PATH_MARKERS):
        return []
    out = []
    for n in walk(tree):
        if isinstance(n, ast.Attribute) and n.attr in ("float64", "double") \
                and _dotted(n) == ["torch", n.attr]:
            out.append(Finding(
                "KAO103", path, n.lineno,
                f"torch.{n.attr} in a device path: the kernels and their "
                "plain versions are float32 end to end; name "
                "torch.float32 (a host float64 reaching the device is "
                "the host-float64 trajectory break)"))
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute) and n.func.attr == "double" \
                and not n.args and not n.keywords:
            out.append(Finding(
                "KAO103", path, n.lineno,
                ".double() in a device path: a float64 tensor; the device "
                "path is float32 end to end (.float())"))
        chain = _dotted(n.func)
        if len(chain) == 2 and chain[0] == "torch" \
                and chain[1] in _TENSOR_FROM_HOST and n.args \
                and _kw(n, "dtype") is None:
            ctor = _np_float64_ctor(n.args[0])
            if ctor is not None:
                out.append(Finding(
                    "KAO103", path, n.lineno,
                    f"torch.{chain[1]}(np.{ctor}(...)) of float literals "
                    "with no dtype= carries numpy's float64 default onto "
                    "the device; pass dtype=np.float32 (device paths must "
                    "not depend on host float64)"))
    return out


# ---------------------------------------------------------------- KAO101

# the sweep engine's stepper factories (make_sweep_stepper_fn,
# make_lane_stepper_fn, make_mega_*stepper_fn): each returns a stepper
# ``(m, state, temps, ...) -> (state', ...)`` that consumes its state
_STEPPER_FACTORY_RE = re.compile(r"^_?make_\w*stepper_fn$")
_STATE_ARG = 1


def _is_stepper_factory_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and bool(
        _STEPPER_FACTORY_RE.match((_dotted(node.func) or [""])[-1]))


def _stmts_in_order(body: list[ast.stmt]):
    for st in body:
        yield st
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            continue  # nested scopes get their own pass
        for sub in (
            getattr(st, "body", []), getattr(st, "orelse", []),
            getattr(st, "finalbody", []),
        ):
            if isinstance(sub, list):
                yield from _stmts_in_order(sub)
        for h in getattr(st, "handlers", []):
            yield from _stmts_in_order(h.body)


def _rule_stepper_reuse(fn, path) -> list[Finding]:
    """A state passed to a stepper is consumed: the stepper's contract
    is that its successor is the RETURNED state (the runtime donation
    guard, ``analysis.sanitize.check_state``, raises on a consumed
    state handed to a stepper again). Flags a read of the consumed name
    before it is rebound; steppers are names bound from a
    ``make_*stepper_fn(...)`` call, or such a call called at once."""
    steppers: set[str] = set()
    consumed: dict[str, int] = {}  # name -> line it was consumed at
    out = []
    for st in _stmts_in_order(fn.body):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue  # nested scopes have their own pass
        # loads of already-consumed names (checked before this
        # statement's own stores rebind them)
        for node in walk(st):
            if isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load) \
                    and node.id in consumed:
                out.append(Finding(
                    "KAO101", path, node.lineno,
                    f"'{node.id}' was passed to a stepper at line "
                    f"{consumed[node.id]} and is consumed; use the "
                    "RETURNED state (the stepper state contract that "
                    "analysis.sanitize's donation guard enforces)"))
                consumed.pop(node.id)  # one report per consumption
        if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                and isinstance(st.targets[0], ast.Name) \
                and _is_stepper_factory_call(st.value):
            steppers.add(st.targets[0].id)
        for node in walk(st):
            if not isinstance(node, ast.Call):
                continue
            if (isinstance(node.func, ast.Name)
                    and node.func.id in steppers) \
                    or _is_stepper_factory_call(node.func):
                if len(node.args) > _STATE_ARG \
                        and isinstance(node.args[_STATE_ARG], ast.Name):
                    consumed[node.args[_STATE_ARG].id] = node.lineno
        # stores rebind (the returned state replacing the consumed one)
        for node in walk(st):
            if isinstance(node, ast.Name) \
                    and isinstance(node.ctx, (ast.Store, ast.Del)):
                consumed.pop(node.id, None)
    return out


# ---------------------------------------------------------------- KAO102

# calls that return a broadcast VIEW of their input (stride 0 on the
# broadcast axes): torch's x.expand/expand_as/broadcast_to and
# torch.broadcast_to, and numpy's np.broadcast_to on the host
_VIEW_METHODS = {"expand", "expand_as", "broadcast_to"}
# a use that materializes the view into a buffer of its own
_MATERIALIZING_METHODS = {"clone", "contiguous", "copy", "astype"}
_MATERIALIZING_CALLS = {"clone", "array", "copy", "ascontiguousarray",
                        "tensor"}


def _is_view_base(value: ast.AST) -> bool:
    return isinstance(value, ast.Call) \
        and isinstance(value.func, ast.Attribute) \
        and value.func.attr in _VIEW_METHODS


def _is_inplace_method(attr: str) -> bool:
    """torch's in-place naming: ``add_``, ``copy_``, ``index_put_`` (and
    an explicit ``__setitem__``)."""
    return attr == "__setitem__" or (
        attr.endswith("_") and not attr.startswith("_"))


def _rule_expanded_base(fn, path, parent) -> list[Finding]:
    """Two state tensors made from one expanded base share ONE storage
    (the view's broadcast axes have stride 0): the aliased-state
    corruption, where a kernel's in-place output through one clobbered
    the other.
    A use of the view ESCAPES when it becomes a tensor of its own — an
    element of a tuple/list/dict, a return value, the value of an
    assignment — and two escapes are two state tensors on one storage.
    Functional uses (``v + 1``, ``f(v)``, ``v > 0``) and materializing
    ones (``v.clone()``, ``v.contiguous()``) are safe. An in-place write
    through the view (``v.copy_(x)``, ``v.add_(1)``, ``v[i] = x``) lands
    on every broadcast row at once, or raises, and is flagged too."""
    bases: dict[str, int] = {}
    for node in _walk_own_scope(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and _is_view_base(node.value):
            bases[node.targets[0].id] = node.lineno
    if not bases:
        return []
    out = []
    escapes: dict[str, int] = {}
    for node in _walk_own_scope(fn):
        if not (isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in bases):
            continue
        p = parent.get(node)
        if isinstance(p, ast.Call) and p.args and p.args[0] is node \
                and _dotted(p.func)[-1:] \
                and _dotted(p.func)[-1] in _MATERIALIZING_CALLS:
            continue
        if isinstance(p, ast.Attribute):
            if p.attr in _MATERIALIZING_METHODS:
                continue
            if _is_inplace_method(p.attr) \
                    and isinstance(parent.get(p), ast.Call):
                out.append(_inplace_finding(path, node, f".{p.attr}()"))
            continue  # a method or attribute read: functional
        if isinstance(p, ast.Subscript):
            if isinstance(p.ctx, ast.Store):
                out.append(_inplace_finding(path, node, "item assignment"))
            continue  # a further view, read
        if isinstance(p, (ast.Tuple, ast.List, ast.Set, ast.Dict,
                          ast.Return, ast.Yield, ast.Starred)) \
                or (isinstance(p, (ast.Assign, ast.AnnAssign))
                    and p.value is node):
            escapes[node.id] = escapes.get(node.id, 0) + 1
            if escapes[node.id] == 2:
                out.append(Finding(
                    "KAO102", path, node.lineno,
                    f"'{node.id}' is an expanded VIEW used as more than "
                    "one state tensor: both share ONE storage, and an "
                    "in-place write through either (a kernel's output, "
                    "copy_) corrupts the other (aliased-state bug class); "
                    "materialize each with .clone()"))
    return out


def _inplace_finding(path, node, how: str) -> Finding:
    return Finding(
        "KAO102", path, node.lineno,
        f"in-place write ({how}) through '{node.id}', an expanded "
        "view: its broadcast elements alias ONE storage element, so the "
        "write lands on every broadcast row at once (or raises); "
        ".clone() the view first (aliased-state bug class)")


# ---------------------------------------------------------------- KAO104

# the port's counter-based PRNG (prng.py): key sources and consumers
_KEY_SOURCES = {"PRNGKey", "split", "fold_in"}
_KEY_CONSUMERS = {"bits", "randint"}


def _prng_call(node: ast.AST, names: set[str]) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = _dotted(node.func)
    return len(chain) >= 2 and chain[-2].lstrip("_") == "prng" \
        and chain[-1] in names


def _rule_key_reuse(fn, path) -> list[Finding]:
    keys: set[str] = set()
    uses: dict[str, int] = {}
    out = []
    for st in _stmts_in_order(fn.body):
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in walk(st):
            if isinstance(node, ast.Assign):
                is_key_src = _prng_call(node.value, _KEY_SOURCES)
                for t in node.targets:
                    names = (
                        [t] if isinstance(t, ast.Name)
                        else [e for e in getattr(t, "elts", [])
                              if isinstance(e, ast.Name)]
                    )
                    for nm in names:
                        if is_key_src:
                            keys.add(nm.id)
                        uses.pop(nm.id, None)  # any rebind resets
            if not _prng_call(node, _KEY_CONSUMERS):
                continue
            for a in node.args:
                if isinstance(a, ast.Name) and a.id in keys:
                    uses[a.id] = uses.get(a.id, 0) + 1
                    if uses[a.id] == 2:
                        out.append(Finding(
                            "KAO104", path, node.lineno,
                            f"PRNG key '{a.id}' consumed by a second "
                            "prng.bits/randint call without split/"
                            "fold_in: the streams are identical, not "
                            "independent"))
    return out


# ---------------------------------------------------------------- KAO105

def _is_factory(fn) -> bool:
    return isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
        and fn.name.lstrip("_").startswith("make")


def _per_tree(fn):
    """Memoize ``fn(tree)`` on the tree: several rules share it."""
    key = "_kao_" + fn.__name__

    def run(tree):
        got = tree.__dict__.get(key)
        if got is None:
            got = tree.__dict__[key] = fn(tree)
        return got

    return run


@_per_tree
def _factory_steps(tree) -> list:
    """Nested defs inside ``make_*`` factories: the steps (and round
    runners) the factories return, which run on device tensors."""
    return [
        inner for n in walk(tree) if _is_factory(n)
        for inner in walk(n)
        if inner is not n
        and isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


def _test_touches_traced(test: ast.expr, params: set[str]) -> bool:
    """True when an ``if``/``while`` test (or a ``bool()`` argument)
    reads a tensor parameter in a way that needs its value on the host."""

    def visit(node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in params
        if isinstance(node, ast.BoolOp):
            return any(visit(v) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            return visit(node.operand)
        if isinstance(node, ast.BinOp):
            return visit(node.left) or visit(node.right)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` is a static structure test
            if all(isinstance(op, (ast.Is, ast.IsNot))
                   for op in node.ops):
                return False
            return any(visit(v) for v in
                       [node.left, *node.comparators])
        if isinstance(node, ast.Subscript):
            return visit(node.value)
        if isinstance(node, ast.Attribute):
            return False  # metadata (shape, dtype) or opaque: skip
        if isinstance(node, ast.Call):
            chain = _dotted(node.func)
            # torch.any(x > t) / (x > t).any() / bool(x) in a Python
            # branch: the value must come to the host
            if len(chain) >= 2 and chain[0] == "torch" \
                    and chain[-1] in _TRACED_REDUCERS:
                return any(visit(a) for a in node.args)
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TRACED_REDUCERS:
                return visit(node.func.value)
            if chain == ["bool"]:
                return any(visit(a) for a in node.args)
            return False  # len(), isinstance(), helpers: static/opaque
        return False

    return visit(test)


def _params(fn) -> set[str]:
    return {
        a.arg for a in (
            fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        ) if a.arg != "self"
    }


def _rule_traced_branch(tree, path) -> list[Finding]:
    out = []
    seen: set[int] = set()
    for fn in _factory_steps(tree):
        params = _params(fn)
        for node in walk(fn):
            if isinstance(node, (ast.If, ast.While)):
                test, kind = node.test, (
                    "while" if isinstance(node, ast.While) else "if")
            elif isinstance(node, ast.Call) \
                    and _dotted(node.func) == ["bool"] and node.args:
                test, kind = node.args[0], "bool()"
            else:
                continue
            if node.lineno in seen or not _test_touches_traced(test, params):
                continue
            seen.add(node.lineno)
            out.append(Finding(
                "KAO105", path, node.lineno,
                f"Python `{kind}` on a tensor inside a step a make_* "
                "factory returns: an implicit host sync (the host waits "
                "for the device mid-step); keep the decision on the "
                "device (torch.where) or read it once after the chunk"))
    return out


# ---------------------------------------------------------------- KAO108

# the resilience surface that must stay host-side: the chaos harness's
# firing/raising/sleeping entry points and the ladder's rung recorder
_CHAOS_HOOKS = {"fires", "raise_if", "sleep_if", "note_rung"}
_CHAOS_MODULES = {"chaos", "ladder", "resilience"}


def _module_defs(tree) -> dict:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _reach(tree, roots) -> list:
    """``roots`` and every module-level function they reach through
    calls by bare name, transitively."""
    defs = _module_defs(tree)
    out, seen, queue = [], set(), list(roots)
    while queue:
        node = queue.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        out.append(node)
        for sub in walk(node):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Name) \
                    and sub.func.id in defs:
                queue.append(defs[sub.func.id])
    return out


def _is_graph_capture(with_node: ast.AST) -> bool:
    return isinstance(with_node, (ast.With, ast.AsyncWith)) and any(
        isinstance(it.context_expr, ast.Call)
        and _dotted(it.context_expr.func)[-2:] == ["cuda", "graph"]
        for it in with_node.items)


@_per_tree
def _captured_bodies(tree) -> list:
    """The ``with torch.cuda.graph(...)`` blocks and the module
    functions they reach: everything that runs under CUDA-graph
    capture (once, at capture; replays re-run only the device work)."""
    return _reach(tree, [n for n in walk(tree)
                         if _is_graph_capture(n)])


def _rule_chaos_in_traced(tree, path) -> list[Finding]:
    """Chaos hooks are host-side only: one inside a factory's step would
    fire inside the device work it is meant to wrap, and one reached
    under CUDA-graph capture fires once at capture and never on replay
    (the graph replays device work only) — the chaos soak would replay
    what the capture saw instead of injecting live."""
    out = []
    seen: set[int] = set()
    for fn in [*_factory_steps(tree), *_captured_bodies(tree)]:
        for node in walk(fn):
            if not isinstance(node, ast.Call):
                continue
            chain = _dotted(node.func)
            if (
                len(chain) >= 2
                and chain[-1] in _CHAOS_HOOKS
                and chain[0].lstrip("_") in _CHAOS_MODULES
                and node.lineno not in seen
            ):
                seen.add(node.lineno)
                out.append(Finding(
                    "KAO108", path, node.lineno,
                    f"{'.'.join(chain)} inside a factory's step or a "
                    "CUDA-graph capture: chaos hooks are host-side only "
                    "(a captured hook fires at capture, never on "
                    "replay); inject at the dispatch call site instead"))
    return out


# ---------------------------------------------------------------- KAO109

# the bound/reseat hot modules: every solve's certificate critical path
# runs through them, so per-partition Python loops there are host
# stalls at scale (they are vectorized; docs/CONSTRUCTOR.md)
_PARTITION_HOT_FILES = ("models/bounds.py", "models/reseat.py")


def _rule_partition_loop(tree, path, rel) -> list[Finding]:
    """Flag ``for`` loops that iterate per partition inside the
    bound/reseat hot modules: a loop whose iterator is
    ``range(<...>.num_parts ...)`` or ``range(<name>)`` where the name
    was bound from a ``num_parts`` read in the same module. Deliberate
    cold fallbacks carry a justified suppression
    (``# kao: disable=KAO109 -- reason``)."""
    if not rel.endswith(_PARTITION_HOT_FILES):
        return []
    return _partition_loop_findings(
        tree, path, "KAO109",
        "per-partition Python `for` loop in a bound/reseat hot "
        "module: this is host time on every solve's certificate "
        "critical path — vectorize over the padded arrays "
        "(docs/CONSTRUCTOR.md) or suppress with justification "
        "for a genuine cold fallback")


def _partition_loop_findings(tree, path, code, msg) -> list[Finding]:
    # names assigned (anywhere in the module) from a .num_parts read —
    # catches the `P = inst.num_parts` / `for p in range(P)` split
    part_names: set[str] = set()
    for n in walk(tree):
        if isinstance(n, ast.Assign) and _mentions_num_parts(n.value):
            for t in n.targets:
                names = (
                    [t] if isinstance(t, ast.Name)
                    else [e for e in getattr(t, "elts", [])
                          if isinstance(e, ast.Name)]
                )
                part_names.update(nm.id for nm in names)

    out = []
    for n in walk(tree):
        if not isinstance(n, ast.For):
            continue
        it = n.iter
        if not (isinstance(it, ast.Call)
                and _dotted(it.func)[-1:] == ["range"]):
            continue
        hit = any(_mentions_num_parts(a) for a in it.args) or any(
            isinstance(a, ast.Name) and a.id in part_names
            for a in it.args
        )
        if hit:
            out.append(Finding(code, path, n.lineno, msg))
    return out


# ---------------------------------------------------------------- KAO112

# the decompose hot modules: split/stitch run over the ultra-jumbo
# FLAT instance before any solve starts (docs/DECOMPOSE.md), so
# per-partition interpreter loops there are host stalls added to every
# decomposed solve's cold path — Python loops may range only over
# groups and racks
_DECOMPOSE_HOT_FILES = ("decompose/split.py", "decompose/stitch.py")


def _rule_decompose_loop(tree, path, rel) -> list[Finding]:
    """KAO109's detector scoped to the decompose hot modules: flag
    ``for`` loops over ``range(...num_parts)`` (or a name bound from
    it) in ``decompose/split.py`` / ``decompose/stitch.py``.
    Deliberate cold fallbacks carry a justified suppression
    (``# kao: disable=KAO112 -- reason``)."""
    if not rel.endswith(_DECOMPOSE_HOT_FILES):
        return []
    return _partition_loop_findings(
        tree, path, "KAO112",
        "per-partition Python `for` loop in a decompose hot module: "
        "split/stitch run over the ultra-jumbo FLAT instance before "
        "any solve starts, so this is host stall on every decomposed "
        "cold path — vectorize with bincount/fancy-index gathers "
        "(docs/DECOMPOSE.md); loops may range only over groups/racks, "
        "or suppress with justification for a genuine cold fallback")


def _bound_names(fn) -> set[str]:
    """Names a function binds itself: parameters plus own-scope stores
    (nested defs excluded — they have their own scopes)."""
    names = {
        a.arg for a in (
            fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        )
    }
    if fn.args.vararg:
        names.add(fn.args.vararg.arg)
    if fn.args.kwarg:
        names.add(fn.args.kwarg.arg)
    for node in _walk_own_scope(fn):
        if isinstance(node, ast.Name) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            names.add(node.id)
    return names



# ---------------------------------------------------------------- KAO110

# the lane-config vocabulary (arrays.LaneConfig / the ModelArrays
# config leaves): values under these names are per-lane search config
# and must reach traced bodies as MODEL DATA, never as captured Python
# scalars (docs/PORTFOLIO.md)
_LANE_CONFIG_NAMES = {
    "lam", "lambda_", "temp_scale", "comp_enable", "lane_config",
}
_LANE_CONFIG_ATTRS = {"lam", "temp_scale", "comp_enable"}
_SCALAR_COERCERS = {"float", "int", "bool"}


def _rule_lane_config_capture(tree, path) -> list[Finding]:
    """Flag lane-config values materialized as Python scalars inside
    ``make_*`` solver-factory bodies (the reference's check). Two shapes:

    - a nested def (the function the factory returns for jit/vmap
      hosting) reading a config-named value from the FACTORY scope —
      a closure capture, i.e. a compile-time constant per config;
    - ``float(x.lam)`` / ``int(cfg.temp_scale)``-style coercions of a
      config attribute anywhere in the factory body (the value can
      only flow onward as a trace-time constant).

    Both bake the value into the step the factory returns (and into
    any CUDA graph it captures), so one step no longer serves every
    lane's config; thread the value as model data instead
    (``ModelArrays.lam``)."""
    out = []
    seen: set[int] = set()
    for fn in walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not fn.name.lstrip("_").startswith("make"):
            continue
        factory_cfg = _bound_names(fn) & _LANE_CONFIG_NAMES
        for inner in walk(fn):
            if inner is fn or not isinstance(
                inner, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            shadowed = _bound_names(inner)
            for node in walk(inner):
                if (
                    isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in factory_cfg
                    and node.id not in shadowed
                    and node.lineno not in seen
                ):
                    seen.add(node.lineno)
                    out.append(Finding(
                        "KAO110", path, node.lineno,
                        f"lane-config value '{node.id}' captured from "
                        f"the enclosing {fn.name}() factory scope: it "
                        "is baked into the step (and into any CUDA "
                        "graph the step captures), which then serves "
                        "one config only; thread it as model data "
                        "(ModelArrays.lam/temp_scale/comp_enable)"))
        for node in walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in _SCALAR_COERCERS
                and node.args
                and isinstance(node.args[0], ast.Attribute)
                and node.args[0].attr in _LANE_CONFIG_ATTRS
                and node.lineno not in seen
            ):
                seen.add(node.lineno)
                out.append(Finding(
                    "KAO110", path, node.lineno,
                    f"{node.func.id}(...{node.args[0].attr}) inside "
                    f"{fn.name}(): coercing a lane-config attribute "
                    "to a Python scalar bakes it into the step (and "
                    "into any CUDA graph the step captures); keep it "
                    "a device scalar of the model"))
    return out



# ---------------------------------------------------------------- KAO111

# the serving tier whose outbound hops must carry the causal context
_HTTP_SCOPE_MARKERS = ("serve.py", "fleet/")


def _is_outbound_http_call(node: ast.AST) -> bool:
    """``conn.request(...)`` / ``urlopen(...)`` call sites — the two
    stdlib outbound-HTTP shapes this tree uses."""
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr in ("request", "urlopen")
    return isinstance(fn, ast.Name) and fn.id == "urlopen"


def _rule_uninjected_http(tree, path, rel) -> list[Finding]:
    """Flag serve/fleet functions making outbound HTTP calls without
    the causal-trace injection vocabulary: no reference to an
    ``inject``-named helper or a ``traceparent`` literal, and no
    header-threading parameter (a function that forwards
    caller-supplied headers delegates propagation to its caller, e.g.
    the router's ``_proxy_once``). One uninjected hop severs the
    router→worker trace join (docs/OBSERVABILITY.md "Distributed
    traces"); genuine non-request traffic (health polls, telemetry
    fan-outs) carries a justified suppression."""
    if not any(m in rel for m in _HTTP_SCOPE_MARKERS):
        return []
    out = []
    for fn in walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = [
            n for n in _walk_own_scope(fn)
            if _is_outbound_http_call(n)
        ]
        if not calls:
            continue
        params = [
            a.arg for a in (fn.args.posonlyargs + fn.args.args
                            + fn.args.kwonlyargs)
        ]
        satisfied = any("header" in p for p in params)
        for node in _walk_own_scope(fn):
            if satisfied:
                break
            if isinstance(node, ast.Name) and "inject" in node.id:
                satisfied = True
            elif isinstance(node, ast.Attribute) \
                    and "inject" in node.attr:
                satisfied = True
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and "traceparent" in node.value.lower():
                satisfied = True
        if satisfied:
            continue
        out.extend(
            Finding(
                "KAO111", path, call.lineno,
                f"outbound HTTP call in {fn.name}() without causal-"
                "trace injection: propagate the active context "
                "(obs.trace.inject -> a traceparent header, or thread "
                "the caller's headers through) so the fleet trace "
                "join survives this hop (docs/OBSERVABILITY.md "
                "'Distributed traces'); read-only non-request "
                "traffic should carry a justified suppression")
            for call in calls
        )
    return out



# ---------------------------------------------------------------- KAO113

# device->host reads: numpy constructors of a bound value, and the tensor
# methods that copy to the host
_HOST_SYNC_NP = {"asarray", "array", "ascontiguousarray"}
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
# where a device-wide synchronize can meet another thread's graph
# capture: the device path and the service that runs solves in threads
_SYNC_SCOPE_MARKERS = ("solvers/tpu", "ops", "parallel", "serve.py")


@_per_tree
def _chunk_step_bodies(tree) -> list:
    """The steps ``make_*stepper_fn`` factories return and every module
    function they reach: the chunk step, which runs once a chunk on the
    ladder's critical path."""
    return _reach(tree, [
        inner for fn in walk(tree)
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        and _STEPPER_FACTORY_RE.match(fn.name)
        for inner in walk(fn)
        if inner is not fn
        and isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef))
    ])


def _is_device_sync(node: ast.AST) -> bool:
    """``torch.cuda.synchronize(...)``: a wait on EVERY stream of the
    device (a stream's or an event's ``.synchronize()`` is not)."""
    return isinstance(node, ast.Call) \
        and _dotted(node.func)[-2:] == ["cuda", "synchronize"]


def _capture_lock_spans(tree) -> list[tuple[int, int]]:
    """Line spans of ``with ..._CAPTURE_LOCK:`` blocks."""
    spans = []
    for n in walk(tree):
        if isinstance(n, (ast.With, ast.AsyncWith)) and any(
            (_dotted(it.context_expr) or [""])[-1] == "_CAPTURE_LOCK"
            for it in n.items
        ):
            spans.append((n.lineno, n.end_lineno or n.lineno))
    return spans


def _rule_step_host_sync(tree, path, rel) -> list[Finding]:
    """Host syncs inside the chunk step or a CUDA-graph capture, and the
    C8 hazard (see the module docstring). In the chunk step each host
    read waits for the device and serializes the ladder's pipelined
    dispatch (the census a graph-captured chunk must first empty); under
    capture a host read is an error that fails the capture."""
    out = []
    seen: set[int] = set()

    def note(lineno, msg):
        if lineno not in seen:
            seen.add(lineno)
            out.append(Finding("KAO113", path, lineno, msg))

    step = [(fn, "the chunk step") for fn in _chunk_step_bodies(tree)]
    capt = [(fn, "a CUDA-graph capture") for fn in _captured_bodies(tree)]
    for fn, where in [*capt, *step]:
        bound = (
            _bound_names(fn)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
            else None  # a with block: every name counts
        )
        for node in walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_SYNC_ATTRS \
                    and not node.args and not node.keywords:
                note(node.lineno,
                     f".{node.func.attr}() inside {where}: a device-to-"
                     "host read that waits for the device; keep the value "
                     "on the device, or read it once after the chunk")
                continue
            if _is_device_sync(node):
                note(node.lineno,
                     f"torch.cuda.synchronize() inside {where}: the host "
                     "waits for every stream of the card mid-step")
                continue
            chain = _dotted(node.func)
            if len(chain) == 2 and chain[0] in ("np", "numpy") \
                    and chain[1] in _HOST_SYNC_NP and node.args and any(
                        isinstance(sub, ast.Name)
                        and (bound is None or sub.id in bound)
                        for sub in walk(node.args[0])):
                note(node.lineno,
                     f"{'.'.join(chain)} of a bound value inside {where}: "
                     "of a device tensor, a device-to-host read that "
                     "waits for the device; stay in torch, or suppress "
                     "with justification where the value is host data")
    if any(m in rel for m in _SYNC_SCOPE_MARKERS):
        spans = _capture_lock_spans(tree)
        for node in walk(tree):
            if _is_device_sync(node) and not any(
                a <= node.lineno <= b for a, b in spans
            ):
                note(node.lineno,
                     "device-wide torch.cuda.synchronize() outside `with "
                     "anneal._CAPTURE_LOCK`: it waits on every stream of "
                     "the card, and while another thread captures a CUDA "
                     "graph (the chain engine) that is an error which "
                     "fails the capture (C8); wait for this thread's "
                     "stream (torch.cuda.current_stream(dev)"
                     ".synchronize(), as engine._sync does)")
    return out


# ---------------------------------------------------------------- KAO115

# the mesh hot modules: the solve mesh is rebuilt between solves (the
# per-bucket sharding search), and every tensor there names its device
_MESH_HOT_MARKER = "parallel/"
_TENSOR_FACTORIES = {
    "tensor", "as_tensor", "zeros", "ones", "full", "empty", "arange",
    "linspace", "eye", "rand", "randn", "randint", "randperm",
}


def _is_devices_call(node: ast.AST) -> bool:
    """A device-list snapshot: ``torch.cuda.device_count()``,
    ``torch.cuda.current_device()`` or ``torch.device("cuda"...)``."""
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    if d[-2:] in (["cuda", "device_count"], ["cuda", "current_device"]):
        return True
    return d == ["torch", "device"] and bool(node.args) \
        and isinstance(node.args[0], ast.Constant) \
        and isinstance(node.args[0].value, str) \
        and node.args[0].value.startswith("cuda")


def _devices_call_in(node: ast.AST) -> ast.Call | None:
    for sub in walk(node):
        if _is_devices_call(sub):
            return sub
    return None


def _rule_mesh_devices(tree, path, rel) -> list[Finding]:
    """Flag two mesh-contract hazards in the ``parallel/`` hot modules:

    - device snapshots frozen across mesh rebuilds: a module-scope
      assignment, a default-argument value, or a device list bound in a
      ``make_*`` factory scope and read from a nested def (the closure
      the factory returns). The sharding search rebuilds the mesh
      between solves, so a frozen list is the stale-mesh bug class —
      resolve devices when the mesh is built, or take the mesh;
    - a tensor created with no explicit ``device=``: it lands on the
      default device, which is not the block's device on a mesh of
      several positions (``torch.from_numpy`` and ``*_like`` are exempt:
      their device is their input's)."""
    if _MESH_HOT_MARKER not in rel:
        return []
    out: list[Finding] = []
    for n in walk(tree):
        if isinstance(n, ast.Call) and _kw(n, "device") is None:
            d = _dotted(n.func)
            if len(d) == 2 and d[0] == "torch" \
                    and d[1] in _TENSOR_FACTORIES:
                out.append(Finding(
                    "KAO115", path, n.lineno,
                    f"torch.{d[1]}(...) without device= in a mesh hot "
                    "module: the tensor lands on the default device, not "
                    "the block's; name the device (a block's, or 'cpu' "
                    "for host data)"))
    # module-scope device snapshot: frozen at import, blind to every
    # later mesh rebuild
    for stmt in tree.body:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                and stmt.value is not None:
            call = _devices_call_in(stmt.value)
            if call is not None:
                out.append(Finding(
                    "KAO115", path, call.lineno,
                    "device list snapshotted at module scope: it freezes "
                    "at import and a rebuilt mesh (make_mesh/"
                    "make_solve_mesh) never sees it; resolve it when the "
                    "mesh is built"))
    for fn in walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(fn.args.defaults) + [
            d for d in fn.args.kw_defaults if d is not None
        ]
        for dflt in defaults:
            call = _devices_call_in(dflt)
            if call is not None:
                out.append(Finding(
                    "KAO115", path, call.lineno,
                    f"device snapshot in a default argument of "
                    f"{fn.name}(): evaluated once at def time and "
                    "frozen across mesh rebuilds (stale-mesh bug "
                    "class); default to None and resolve inside the "
                    "body"))
        if not _is_factory(fn):
            continue
        # device lists bound in the factory scope...
        dev_names: set[str] = set()
        for node in _walk_own_scope(fn):
            if isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and node.value is not None \
                    and _devices_call_in(node.value) is not None:
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    for e in (getattr(t, "elts", None) or [t]):
                        if isinstance(e, ast.Name):
                            dev_names.add(e.id)
        if not dev_names:
            continue
        # ...read from a nested def: the returned closure pins the
        # snapshot for its whole lifetime
        for inner in walk(fn):
            if inner is fn or not isinstance(
                inner, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            shadowed = _bound_names(inner)
            for node in walk(inner):
                if (
                    isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Load)
                    and node.id in dev_names
                    and node.id not in shadowed
                ):
                    out.append(Finding(
                        "KAO115", path, node.lineno,
                        f"device list '{node.id}' captured from the "
                        f"enclosing {fn.name}() factory scope into a "
                        "closure: the snapshot outlives every mesh "
                        "rebuild (stale-mesh bug class); resolve devices "
                        "per dispatch or take the mesh as a parameter"))
    return out


def _mentions_num_parts(node: ast.AST) -> bool:
    return any(
        isinstance(sub, ast.Attribute) and sub.attr == "num_parts"
        for sub in walk(node)
    )


# ---------------------------------------------------------------- KAO107

def _string_literals(tree):
    for n in walk(tree):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n.lineno, n.value
        elif isinstance(n, ast.JoinedStr):
            for v in n.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    yield n.lineno, v.value


_FAMILY_RE = re.compile(r"^kao_[a-z0-9_]+$")


def _family(sample: str) -> str:
    name = sample.split("{")[0].split()[0]
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name


def _rule_metrics_help_type(tree, path) -> list[Finding]:
    emitted: dict[str, int] = {}
    documented: dict[str, set[str]] = {}
    for lineno, s in _string_literals(tree):
        stripped = s.lstrip()
        if stripped.startswith("# HELP ") or stripped.startswith("# TYPE "):
            kind = stripped.split()[1]
            rest = stripped.split()[2:]
            if rest and rest[0].startswith("kao_"):
                documented.setdefault(_family(rest[0]), set()).add(kind)
        elif stripped.startswith("kao_"):
            # only exposition-shaped literals count as emission: the
            # family name must be followed by a label brace, or by
            # nothing but whitespace (an f-string sample prefix like
            # "kao_x " with the value interpolated). A bare "kao_foo"
            # (contextvar names, .so basenames) or prose containing
            # the name is not a metric sample.
            head = stripped.split("{")[0].split()[0]
            rest = stripped[len(head):]
            if not _FAMILY_RE.match(_family(head)):
                continue
            if not (rest.startswith("{")
                    or (rest != "" and rest.strip() == "")):
                continue
            emitted.setdefault(_family(head), lineno)
    return [
        Finding("KAO107", path, line,
                f"metric family '{fam}' emitted without # HELP and "
                "# TYPE in this module (Prometheus exposition "
                "contract, tests/test_metrics_format.py)")
        for fam, line in sorted(emitted.items(), key=lambda kv: kv[1])
        if documented.get(fam, set()) != {"HELP", "TYPE"}
    ]


# ---------------------------------------------------------------- KAO114

# the dispatch hot modules: every wall-clock delta measured here sits
# on a solve's critical path, and the attribution-ledger contract
# is ONE accounting funnel — obs.flight windows, retire/
# record sinks, span attrs, result fields — so the ledger's
# sums-to-wall invariant stays meaningful
_ACCOUNTING_HOT_FILES = ("parallel/mesh.py", "solvers/tpu/engine.py")
_TIMER_FNS = {"perf_counter", "monotonic", "time"}
# a function "reaches a dispatch/compile site" when it calls one of
# these shapes — pure host helpers that merely time themselves are
# out of scope
_DISPATCH_SITE_RE = re.compile(
    r"dispatch|compile|solve_|block_until_ready|fetch_global|lower"
)
# call names that COUNT as the accounting funnel: flight/prof note_*
# hooks, record/observe/retire sinks, span-attr setters, ledger/window
# helpers, and result constructors whose consumers do the recording
_FUNNEL_RE = re.compile(
    r"note_|record|observe|retire|attrs|\.set$|\.update$|SolveResult"
    r"|_select_lanes|ledger|window|attribute|chunk_attrs"
)


def _is_timer_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    return len(d) == 2 and d[0] == "time" and d[1] in _TIMER_FNS


def _is_timer_delta(node: ast.AST) -> bool:
    """A literal wall-clock measurement: ``time.perf_counter() - t0``.
    Timer on the LEFT only — elapsed wall is always now-minus-mark,
    while ``deadline - time.perf_counter()`` (timer on the right) is a
    remaining-headroom check, control flow rather than measurement."""
    return (
        isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)
        and _is_timer_call(node.left)
    )


def _call_name(call: ast.Call) -> str:
    d = _dotted(call.func)
    if d:
        return ".".join(d)
    if isinstance(call.func, ast.Attribute):
        # method on a computed receiver (``span(...).set``): the attr
        # alone still identifies the funnel vocabulary
        return "." + call.func.attr
    return ""


def _names_in(node: ast.AST, names) -> set[str]:
    return {
        n.id for n in walk(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
        and n.id in names
    }


def _rule_time_delta(tree, path, rel) -> list[Finding]:
    """Flag ``time.perf_counter()``-style deltas in the dispatch hot
    modules that never reach the accounting funnel. A delta (or a name
    bound from one, through simple assignment chains) is CLEAN when it
    escapes into a funnel call (``note_*``/record/observe/retire/
    span-``.set``/``chunk_attrs``/``SolveResult``/...), a ``return``
    value, an attribute or subscript store, or an augmented assignment
    to a ``nonlocal``/``global`` accumulator — all shapes whose
    consumers land the seconds in a flight record. Anything else
    (a delta feeding only a log line, a print, or a branch) is wall
    the ledger cannot attribute. Suppressible with justification
    (``# kao: disable=KAO114 -- reason``) for genuinely
    non-accountable timing (e.g. test-only instrumentation)."""
    if not rel.endswith(_ACCOUNTING_HOT_FILES):
        return []
    out: list[Finding] = []
    for fn in walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out += _time_delta_findings(fn, path)
    return out


def _time_delta_findings(fn, path) -> list[Finding]:
    own = list(_walk_own_scope(fn))
    deltas = [n for n in own if _is_timer_delta(n)]
    if not deltas:
        return []
    # scope gate: only functions that reach a dispatch/compile site
    if not any(
        isinstance(n, ast.Call)
        and _DISPATCH_SITE_RE.search(_call_name(n))
        for n in own
    ):
        return []
    parents: dict[ast.AST, ast.AST] = {}
    for node in walk(fn):
        for child in children(node):
            parents[child] = node
    shared = {
        nm for n in own
        if isinstance(n, (ast.Nonlocal, ast.Global)) for nm in n.names
    }

    # origins: tainted name -> delta lines it carries; pending/escaped
    # track delta lines still unaccounted vs proven funneled
    origins: dict[str, set[int]] = {}
    pending: set[int] = set()
    escaped: set[int] = set()
    immediate: list[int] = []

    def _stmt_and_funnel(node):
        """Walk up to the enclosing statement; True when any ancestor
        call on the way matches the funnel vocabulary."""
        funneled = False
        cur = node
        while cur in parents and not isinstance(cur, ast.stmt):
            cur = parents[cur]
            if isinstance(cur, ast.Call) \
                    and _FUNNEL_RE.search(_call_name(cur)):
                funneled = True
        return cur, funneled

    for d in deltas:
        stmt, funneled = _stmt_and_funnel(d)
        if funneled or isinstance(stmt, ast.Return):
            continue
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        if targets:
            flat = [
                e for t in targets
                for e in (getattr(t, "elts", None) or [t])
            ]
            if any(isinstance(t, (ast.Attribute, ast.Subscript))
                   for t in flat):
                continue  # stored on an object/container: escapes
            if isinstance(stmt, ast.AugAssign) and any(
                isinstance(t, ast.Name) and t.id in shared for t in flat
            ):
                continue  # accumulated into a shared tally
            names = [t.id for t in flat if isinstance(t, ast.Name)]
            if names:
                for nm in names:
                    origins.setdefault(nm, set()).add(d.lineno)
                pending.add(d.lineno)
                continue
        immediate.append(d.lineno)

    # propagate taint through assignment chains and find escapes, to a
    # fixpoint (chains are short; this converges in a few passes)
    changed = True
    while changed and pending - escaped:
        changed = False
        for n in own:
            if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)) \
                    and n.value is not None:
                hit = set().union(*(
                    origins[nm] for nm in _names_in(n.value, origins)
                )) if _names_in(n.value, origins) else set()
                if not hit:
                    continue
                targets = (
                    n.targets if isinstance(n, ast.Assign) else [n.target]
                )
                flat = [
                    e for t in targets
                    for e in (getattr(t, "elts", None) or [t])
                ]
                for t in flat:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        if not hit <= escaped:
                            escaped |= hit
                            changed = True
                    elif isinstance(t, ast.Name):
                        if isinstance(n, ast.AugAssign) \
                                and t.id in shared:
                            if not hit <= escaped:
                                escaped |= hit
                                changed = True
                        elif not hit <= origins.setdefault(t.id, set()):
                            origins[t.id] |= hit
                            changed = True
            elif isinstance(n, ast.Call) \
                    and _FUNNEL_RE.search(_call_name(n)):
                hit = set().union(*(
                    origins[nm] for nm in _names_in(n, origins)
                )) if _names_in(n, origins) else set()
                if hit and not hit <= escaped:
                    escaped |= hit
                    changed = True
            elif isinstance(n, ast.Return) and n.value is not None:
                hit = set().union(*(
                    origins[nm] for nm in _names_in(n.value, origins)
                )) if _names_in(n.value, origins) else set()
                if hit and not hit <= escaped:
                    escaped |= hit
                    changed = True

    msg = (
        "wall-clock delta outside the accounting funnel in a "
        "dispatch hot module: this timing never reaches obs.flight "
        "(note_window/note_device/attribute) or a recording sink, so "
        "the attribution ledger's sums-to-wall invariant cannot see "
        "it (docs/OBSERVABILITY.md 'Attribution ledgers'); route it "
        "through the funnel or suppress with justification"
    )
    return [
        Finding("KAO114", path, ln, msg)
        for ln in sorted(set(immediate) | (pending - escaped))
    ]

