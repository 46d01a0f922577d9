"""Lock-discipline rules (KAO116-119) over an inferred lock map.

Counterpart of ``kafka_assignment_optimizer_tpu.analysis.concurrency``,
rule for rule: these rules are language-general, so they give the
reference's findings on the same source (the blocking-call vocabulary
included, whose compile/dispatch names are the reference's).

The serving plane mutates shared state across ~50 ``threading.Lock`` /
``RLock`` / ``Condition`` sites; this pass turns that discipline into a
declared, checked artifact instead of reviewer folklore:

- **lock map** — per class (and per module, for module-global locks),
  infer which lock guards which attribute from AST evidence: an
  attribute written lexically inside ``with self._lock:`` at least once
  is treated as guarded by that lock. Explicit declaration beats
  inference: a ``# kao: guards(attr, ...)`` trailing comment on the
  lock's assignment line pins the guarded set.
- **KAO116** — a guarded attribute mutated outside its lock (anywhere
  but ``__init__``, which runs before the object is shared).
- **KAO117** — a blocking call (HTTP, no-timeout ``queue.get``,
  ``subprocess``, bare ``.wait()``/``.join()``, jax compile/dispatch
  entry points) made while a lock is held: the classic "metrics lock
  around a network round-trip" convoy.
- **KAO118** — a lock-acquisition-order cycle (static deadlock
  candidate): ``with A: with B`` in one place, ``with B: with A`` in
  another. Edges also follow one level of same-class ``self.m()`` and
  same-module ``f()`` calls; cross-file cycles are stitched by
  ``lint_paths``.
- **KAO119** — ``threading.Thread(...)`` in a serving-plane module
  (serve.py, fleet/, rollout/, watch/) with no ``daemon=`` decision, no
  ``.join()`` in the same scope, and no attribute registration: an
  orphan that outlives shutdown and deadlocks interpreter exit.

Held regions are lexical: ``with <lock>:`` bodies, plus a coarse
``<lock>.acquire(...)`` extension to the end of the enclosing block
(the ``acquire(timeout=)/try/finally`` idiom). The runtime complement
is :mod:`.lsan`, which observes the real acquisition order.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field

from .findings import Finding
from .rules_ast import children, walk

# a lock constructed via threading.Lock()/RLock()/Condition() (bare
# names tolerated for `from threading import Lock` style)
_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

# container-mutation method names that count as a write to the receiver
_MUTATORS = {
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear", "sort",
    "appendleft", "popleft",
}

# methods that run before (or while) the object is published; writes
# here are construction, not racing mutation
_CTOR_METHODS = {"__init__", "__new__", "__post_init__"}

_GUARDS_RE = re.compile(r"#\s*kao:\s*guards\(([^)]*)\)")

_THREAD_SCOPE_MARKERS = ("serve.py", "fleet/", "rollout/", "watch/")


def _is_lock_ctor(node: ast.AST) -> ast.Call | None:
    if not isinstance(node, ast.Call):
        return None
    d = _dotted_name(node.func)
    if not d:
        return None
    if d[-1] not in _LOCK_FACTORIES:
        return None
    if len(d) == 1 or d[-2].lstrip("_") == "threading":
        return node
    return None


def _dotted_name(node: ast.AST) -> list[str]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


@dataclass(frozen=True)
class LockId:
    """Canonical identity of one lock across the project graph."""

    rel: str          # package-relative posix path
    owner: str        # class name, "" for module globals, "?" unresolved
    name: str         # attribute / global name

    def render(self) -> str:
        dot = f"{self.owner}." if self.owner else ""
        return f"{self.rel}::{dot}{self.name}"


@dataclass(frozen=True)
class LockEdge:
    """``held`` was held when ``acquired`` was taken at path:line."""

    held: LockId
    acquired: LockId
    path: str
    rel: str
    line: int


@dataclass
class _ScopeLocks:
    """Lock fields of one class (or the module, owner='')."""

    owner: str
    locks: dict[str, int] = field(default_factory=dict)   # name -> line
    alias: dict[str, str] = field(default_factory=dict)   # cond -> lock
    declared: dict[str, set[str]] = field(default_factory=dict)
    conditions: set[str] = field(default_factory=set)

    def canonical(self, name: str) -> str:
        seen = set()
        while name in self.alias and name not in seen:
            seen.add(name)
            name = self.alias[name]
        return name


def _declared_guards(lines: list[str], lineno: int) -> set[str]:
    if 1 <= lineno <= len(lines):
        m = _GUARDS_RE.search(lines[lineno - 1])
        if m:
            return {a.strip() for a in m.group(1).split(",") if a.strip()}
    return set()


def _collect_class_locks(
    cls: ast.ClassDef, lines: list[str]
) -> _ScopeLocks:
    sc = _ScopeLocks(owner=cls.name)
    for fn in cls.body:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            call = _is_lock_ctor(node.value)
            guards = _declared_guards(lines, node.lineno)
            if call is None and not guards:
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    # a guards() comment on any assignment registers
                    # the field as a lock even when the lock object is
                    # injected rather than constructed here
                    sc.locks[t.attr] = node.lineno
                    if guards:
                        sc.declared[t.attr] = guards
                    d = _dotted_name(call.func) if call else [""]
                    if d[-1] == "Condition":
                        sc.conditions.add(t.attr)
                        if (
                            call.args
                            and isinstance(call.args[0], ast.Attribute)
                            and isinstance(call.args[0].value, ast.Name)
                            and call.args[0].value.id == "self"
                        ):
                            sc.alias[t.attr] = call.args[0].attr
    return sc


def _collect_module_locks(
    tree: ast.Module, lines: list[str]
) -> _ScopeLocks:
    sc = _ScopeLocks(owner="")
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        call = _is_lock_ctor(stmt.value)
        if call is None:
            continue
        for t in stmt.targets:
            if isinstance(t, ast.Name):
                sc.locks[t.id] = stmt.lineno
                guards = _declared_guards(lines, stmt.lineno)
                if guards:
                    sc.declared[t.id] = guards
                if _dotted_name(call.func)[-1] == "Condition":
                    sc.conditions.add(t.id)
    return sc


# ------------------------------------------------------------------
# held-region walk

_BLOCK_FIELDS = {"body", "orelse", "finalbody"}


def _header_exprs(stmt: ast.stmt):
    """Expression children of ``stmt`` excluding nested statement
    blocks (those are walked separately with their own held set)."""
    for name, val in ast.iter_fields(stmt):
        if name in _BLOCK_FIELDS or name == "handlers":
            continue
        vals = val if isinstance(val, list) else [val]
        for v in vals:
            if isinstance(v, ast.AST) and not isinstance(v, ast.stmt):
                yield v


@dataclass
class _Event:
    """One lock acquisition observed during the walk."""

    held: tuple[LockId, ...]
    lock: LockId
    line: int


class _FnWalk:
    """Walks one function's own scope tracking the held-lock stack.

    Produces: ``writes`` (attr/global mutation sites with held set),
    ``calls`` (expression nodes with held set, for KAO117),
    ``events`` (acquisitions, for KAO118 edges), ``self_calls`` and
    ``local_calls`` (depth-1 interprocedural edges).
    """

    def __init__(self, resolve):
        self.resolve = resolve           # expr -> LockId | None
        self.events: list[_Event] = []
        self.exprs: list[tuple[ast.AST, tuple[LockId, ...]]] = []
        self.calls: list[tuple[str, str, tuple[LockId, ...], int]] = []

    def walk(self, stmts: list[ast.stmt], held: tuple[LockId, ...]):
        extra: list[LockId] = []
        for st in stmts:
            cur = held + tuple(extra)
            if isinstance(
                st,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                newly: list[LockId] = []
                for item in st.items:
                    self._note_exprs(item.context_expr, cur)
                    if item.optional_vars is not None:
                        self._note_exprs(item.optional_vars, cur)
                    lid = self.resolve(item.context_expr)
                    if lid is not None:
                        self.events.append(
                            _Event(cur + tuple(newly), lid,
                                   item.context_expr.lineno))
                        newly.append(lid)
                self.walk(st.body, cur + tuple(newly))
                continue
            # the statement node itself carries the write shapes
            # (Assign/AugAssign/AnnAssign/Delete) for _attr_writes
            self.exprs.append((st, cur))
            for e in _header_exprs(st):
                self._note_exprs(e, cur)
                # <lock>.acquire(...) holds to the end of this block
                for n in walk(e):
                    if (
                        isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "acquire"
                    ):
                        lid = self.resolve(n.func.value)
                        if lid is not None:
                            self.events.append(
                                _Event(cur, lid, n.lineno))
                            extra.append(lid)
            for fname in _BLOCK_FIELDS:
                sub = getattr(st, fname, None)
                if sub:
                    self.walk(sub, held + tuple(extra))
            for h in getattr(st, "handlers", None) or []:
                if h.type is not None:
                    self._note_exprs(h.type, held + tuple(extra))
                self.walk(h.body, held + tuple(extra))

    def _note_exprs(self, expr: ast.AST, held: tuple[LockId, ...]):
        stack = [expr]
        while stack:
            n = stack.pop()
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                # nested defs run later, on an unknown held set
                continue
            stack.extend(children(n))
            self.exprs.append((n, held))
            if isinstance(n, ast.Call):
                if (
                    isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == "self"
                ):
                    self.calls.append(
                        ("self", n.func.attr, held, n.lineno))
                elif isinstance(n.func, ast.Name):
                    self.calls.append(
                        ("module", n.func.id, held, n.lineno))


def _function_nodes(tree: ast.AST):
    """Yield (class_name_or_None, fn) for every def in the module."""
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, node
            yield from _nested(None, node)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    yield node.name, sub
                    yield from _nested(node.name, sub)


def _nested(cls: str | None, fn: ast.AST):
    for node in walk(fn):
        if node is fn:
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield cls, node


@dataclass
class ModuleConcurrency:
    """Everything the per-file pass learned about one module."""

    findings: list[Finding] = field(default_factory=list)
    edges: list[LockEdge] = field(default_factory=list)


def _make_resolver(rel, cls_locks: _ScopeLocks | None,
                   mod_locks: _ScopeLocks):
    def resolve(expr: ast.AST) -> LockId | None:
        if isinstance(expr, ast.Call):
            # with self._cluster_lock(cid): — a lock-factory method;
            # all members of the family share one identity (the pass
            # checks the discipline, not per-key aliasing)
            f = expr.func
            if (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and _lockish(f.attr)
            ):
                owner = cls_locks.owner if cls_locks else "?"
                return LockId(rel, owner, f.attr + "()")
            return None
        if isinstance(expr, ast.Name):
            if expr.id in mod_locks.locks:
                return LockId(rel, "", mod_locks.canonical(expr.id))
            return None
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self":
                if cls_locks is not None \
                        and expr.attr in cls_locks.locks:
                    return LockId(rel, cls_locks.owner,
                                  cls_locks.canonical(expr.attr))
                if _lockish(expr.attr):
                    # lock injected via a parameter: no ctor evidence,
                    # but the name convention is load-bearing
                    owner = cls_locks.owner if cls_locks else "?"
                    return LockId(rel, owner, expr.attr)
                return None
            # other-receiver lock attr (c.lock, w._lock): merge by
            # attribute name within the file — enough for the
            # per-cluster-lock idiom, never stitched across files
            if _lockish(expr.attr):
                return LockId(rel, "?", expr.attr)
        return None
    return resolve


def _lockish(attr: str) -> bool:
    return (attr == "lock" or attr.endswith("_lock")
            or attr in ("_cv", "_cond") or attr.endswith("_cond"))


# ------------------------------------------------------------------
# write-site extraction (KAO116)

def _attr_writes(exprs, owner_is_self=True):
    """Yield (attr_name, lineno, held) write sites against ``self``."""
    for n, held in exprs:
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                n.targets if isinstance(n, ast.Assign) else [n.target]
            )
            for t in targets:
                for e in getattr(t, "elts", None) or [t]:
                    a = _self_attr(e)
                    if a:
                        yield a, n.lineno, held
        elif isinstance(n, ast.Delete):
            for t in n.targets:
                a = _self_attr(t)
                if a:
                    yield a, n.lineno, held
        elif isinstance(n, ast.Call) and isinstance(
            n.func, ast.Attribute
        ) and n.func.attr in _MUTATORS:
            a = _self_attr(n.func.value)
            if a:
                yield a, n.lineno, held


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` or ``self.X[...]`` -> ``X``."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _global_writes(fn, exprs, mod_names: set[str]):
    """Yield (global_name, lineno, held) mutation sites in ``fn``."""
    declared_global: set[str] = set()
    for n in walk(fn):
        if isinstance(n, ast.Global):
            declared_global.update(n.names)
    local = _locals_of(fn) - declared_global
    for n, held in exprs:
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (
                n.targets if isinstance(n, ast.Assign) else [n.target]
            )
            for t in targets:
                for e in getattr(t, "elts", None) or [t]:
                    g = _global_sub(e, mod_names, local,
                                    declared_global)
                    if g:
                        yield g, n.lineno, held
        elif isinstance(n, ast.Call) and isinstance(
            n.func, ast.Attribute
        ) and n.func.attr in _MUTATORS \
                and isinstance(n.func.value, ast.Name):
            g = n.func.value.id
            if g in mod_names and g not in local:
                yield g, n.lineno, held


def _global_sub(node, mod_names, local, declared_global):
    if isinstance(node, ast.Subscript) \
            and isinstance(node.value, ast.Name):
        g = node.value.id
        if g in mod_names and g not in local:
            return g
    if isinstance(node, ast.Name) and node.id in declared_global \
            and node.id in mod_names:
        return node.id
    return None


def _locals_of(fn) -> set[str]:
    names = set()
    a = fn.args
    for arg in (
        list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
        + ([a.vararg] if a.vararg else [])
        + ([a.kwarg] if a.kwarg else [])
    ):
        names.add(arg.arg)
    for n in walk(fn):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            names.add(n.id)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)) and n is not fn:
            names.add(n.name)
    return names


# ------------------------------------------------------------------
# KAO117 blocking-call classification

_SUBPROC_FNS = {"run", "Popen", "call", "check_call", "check_output"}
_JAX_BLOCKING = {"block_until_ready", "device_put", "device_get",
                 "compile", "lower"}
_QUEUE_NAME_RE = re.compile(r"(^|_)(q|queue|work|jobs)s?$", re.I)


def _blocking_reason(call: ast.Call) -> str | None:
    d = _dotted_name(call.func)
    if not d:
        return None
    last = d[-1]
    if last == "sleep" and d[0] == "time":
        return "time.sleep()"
    if last == "urlopen":
        return "HTTP round-trip (urlopen)"
    if last in ("request", "getresponse") and len(d) == 2:
        return f"HTTP round-trip (.{last}())"
    if d[0] == "subprocess" and last in _SUBPROC_FNS:
        return f"subprocess.{last}()"
    if last in _JAX_BLOCKING and isinstance(call.func, ast.Attribute):
        return f"jax compile/dispatch ({last})"
    if last in ("solve_tpu", "solve_tpu_batch", "optimize",
                "optimize_delta"):
        return f"solver dispatch ({last})"
    if last == "get" and isinstance(call.func, ast.Attribute):
        recv = _dotted_name(call.func.value)
        if recv and _QUEUE_NAME_RE.search(recv[-1]):
            if not call.args and not any(
                k.arg in ("timeout", "block") for k in call.keywords
            ):
                return "queue.get() without a timeout"
    if last in ("join", "wait") and isinstance(
        call.func, ast.Attribute
    ) and not call.args and not call.keywords:
        return f"unbounded .{last}()"
    return None


# ------------------------------------------------------------------
# the per-file pass

def analyze_module(
    tree: ast.Module, text: str, path: str, rel: str
) -> ModuleConcurrency:
    lines = text.splitlines()
    mod_locks = _collect_module_locks(tree, lines)
    cls_locks: dict[str, _ScopeLocks] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            cls_locks[node.name] = _collect_class_locks(node, lines)

    mod_names = {
        t.id
        for stmt in tree.body
        if isinstance(stmt, (ast.Assign, ast.AnnAssign))
        for t in (stmt.targets if isinstance(stmt, ast.Assign)
                  else [stmt.target])
        if isinstance(t, ast.Name)
    } - set(mod_locks.locks)

    mc = ModuleConcurrency()

    # per-(class, attr) and per-global write ledgers
    cls_writes: dict[tuple[str, str], list] = {}
    glob_writes: dict[str, list] = {}
    # depth-1 interprocedural: direct acquisitions per function
    direct_acq: dict[tuple[str, str], set[LockId]] = {}
    call_sites: list[tuple[str | None, str, str,
                           tuple[LockId, ...], int]] = []

    fns = list(_function_nodes(tree))

    # pass 1: walk every function with an empty held set to learn the
    # lock context of every call site
    call_held: dict[tuple[str, str], list[tuple[LockId, ...]]] = {}
    for cls_name, fn in fns:
        sc = cls_locks.get(cls_name) if cls_name else None
        w = _FnWalk(_make_resolver(rel, sc, mod_locks))
        w.walk(fn.body, ())
        for kind, name, held, _line in w.calls:
            k = (cls_name or "", name) if kind == "self" else ("", name)
            call_held.setdefault(k, []).append(held)

    def _seed(cls_name: str | None, fn) -> tuple[LockId, ...]:
        """Locks assumed held on entry: the ``*_locked`` naming
        convention, plus any lock held at EVERY observed call site
        (depth-1 caller-context propagation — how ``_detector``-style
        helpers called under ``with self._lock:`` stay clean)."""
        seed: set[LockId] = set()
        sc = cls_locks.get(cls_name) if cls_name else None
        if fn.name.endswith("_locked") and sc is not None:
            for name in sc.locks:
                seed.add(LockId(rel, sc.owner, sc.canonical(name)))
        sites = call_held.get((cls_name or "", fn.name), [])
        if sites:
            common = set(sites[0])
            for h in sites[1:]:
                common &= set(h)
            seed |= common
        return tuple(sorted(seed, key=lambda x: x.render()))

    # pass 2: the real walk, with seeded entry contexts
    for cls_name, fn in fns:
        sc = cls_locks.get(cls_name) if cls_name else None
        resolve = _make_resolver(rel, sc, mod_locks)
        w = _FnWalk(resolve)
        w.walk(fn.body, _seed(cls_name, fn))
        key = (cls_name or "", fn.name)
        direct_acq.setdefault(key, set()).update(
            e.lock for e in w.events
        )
        for ev in w.events:
            for h in ev.held:
                if h != ev.lock:
                    mc.edges.append(
                        LockEdge(h, ev.lock, path, rel, ev.line))
        for kind, name, held, line in w.calls:
            call_sites.append((cls_name, kind, name, held, line))
        in_ctor = fn.name in _CTOR_METHODS
        if cls_name:
            for attr, line, held in _attr_writes(w.exprs):
                cls_writes.setdefault((cls_name, attr), []).append(
                    (line, held, in_ctor, fn.name))
        # main() is the process entry point: its config writes happen
        # before any worker thread exists (the module-global analog of
        # the __init__ exemption)
        pre_threading = cls_name is None and fn.name == "main"
        for g, line, held in _global_writes(fn, w.exprs, mod_names):
            glob_writes.setdefault(g, []).append(
                (line, held, pre_threading, fn.name))
        # KAO117: blocking calls on a non-empty held stack
        for n, held in w.exprs:
            if not held or not isinstance(n, ast.Call):
                continue
            reason = _blocking_reason(n)
            if reason is None:
                continue
            # Condition.wait() releases the lock it wraps: legitimate
            if _is_wait_on_held_condition(n, held, sc, mod_locks, rel):
                continue
            mc.findings.append(Finding(
                "KAO117", path, n.lineno,
                f"blocking call ({reason}) while holding "
                f"{held[-1].render()}: every other thread touching "
                "that lock convoys behind this latency; move the "
                "blocking work outside the critical section"))

    # depth-1 interprocedural edges: holding H, call a local def that
    # itself acquires
    for cls_name, kind, name, held, line in call_sites:
        if not held:
            continue
        key = (cls_name or "", name) if kind == "self" else ("", name)
        for lid in direct_acq.get(key, ()):  # noqa: B007
            for h in held:
                if h != lid:
                    mc.edges.append(LockEdge(h, lid, path, rel, line))

    # KAO116: guarded attr written outside its lock
    mc.findings += _unguarded_writes(
        cls_writes, cls_locks, rel, path, per_class=True)
    mc.findings += _unguarded_writes(
        {("", g): w for g, w in glob_writes.items()},
        {"": mod_locks}, rel, path, per_class=False)

    # KAO119: unmanaged thread starts in serving-plane modules
    if any(m in rel for m in _THREAD_SCOPE_MARKERS):
        mc.findings += _thread_lifecycle(tree, path)

    # intra-file cycles (cross-file cycles are stitched in lint_paths)
    mc.findings += cycle_findings(mc.edges)
    return mc


def _is_wait_on_held_condition(call, held, sc, mod_locks, rel) -> bool:
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == "wait"):
        return False
    recv = call.func.value
    if isinstance(recv, ast.Attribute) and isinstance(
        recv.value, ast.Name
    ) and recv.value.id == "self" and sc is not None:
        if recv.attr in sc.conditions:
            lid = LockId(rel, sc.owner, sc.canonical(recv.attr))
            return lid in held
    if isinstance(recv, ast.Name) and recv.id in mod_locks.conditions:
        lid = LockId(rel, "", mod_locks.canonical(recv.id))
        return lid in held
    return False


def _unguarded_writes(writes, lock_scopes, rel, path, *, per_class):
    out: list[Finding] = []
    for (owner, attr), sites in sorted(writes.items()):
        sc = lock_scopes.get(owner)
        if sc is None:
            continue
        # declared beats inferred
        guard: str | None = None
        for lock_name, attrs in sc.declared.items():
            if attr in attrs:
                guard = sc.canonical(lock_name)
                break
        if guard is None:
            under = {
                lid.name
                for _, held, in_ctor, _m in sites
                for lid in held
                if lid.owner == owner and lid.rel == rel
            }
            if len(under) != 1:
                continue  # never locked, or ambiguous across locks
            guard = next(iter(under))
        lid = LockId(rel, owner, guard)
        for line, held, in_ctor, meth in sites:
            if in_ctor or lid in held:
                continue
            what = (f"{owner}.{attr}" if per_class and owner
                    else attr)
            out.append(Finding(
                "KAO116", path, line,
                f"'{what}' is guarded by {lid.render()} (see other "
                f"write sites) but mutated here in {meth}() without "
                "it: a racing reader/writer under the lock sees torn "
                "state; take the lock or declare the discipline with "
                "'# kao: guards(...)'"))
    return out


def _thread_lifecycle(tree: ast.Module, path: str) -> list[Finding]:
    out: list[Finding] = []
    joined: set[str] = set()
    registered_lines: set[int] = set()
    for n in walk(tree):
        if isinstance(n, ast.Call) and isinstance(
            n.func, ast.Attribute
        ) and n.func.attr == "join":
            d = _dotted_name(n.func.value)
            if d:
                joined.add(d[-1])
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Attribute):
                    # self._thread = Thread(...): lifecycle registered
                    for c in walk(n.value):
                        if _is_thread_ctor(c):
                            registered_lines.add(c.lineno)
    assigns: dict[int, str] = {}
    for n in walk(tree):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name):
            for c in walk(n.value):
                if _is_thread_ctor(c):
                    assigns[c.lineno] = n.targets[0].id
    for n in walk(tree):
        if not _is_thread_ctor(n):
            continue
        if n.lineno in registered_lines:
            continue
        if any(k.arg == "daemon" for k in n.keywords):
            continue
        name = assigns.get(n.lineno)
        if name and name in joined:
            continue
        out.append(Finding(
            "KAO119", path, n.lineno,
            "threading.Thread(...) started with no lifecycle "
            "decision: not daemon=, never join()ed, not registered "
            "on an owner attribute — it outlives drain/shutdown and "
            "can hang interpreter exit; pick one explicitly"))
    return out


def _is_thread_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted_name(node.func)
    return bool(d) and d[-1] == "Thread" and (
        len(d) == 1 or d[-2].lstrip("_") == "threading"
    )


# ------------------------------------------------------------------
# KAO118 cycle detection (shared by lint_source and lint_paths)

def cycle_findings(edges: list[LockEdge]) -> list[Finding]:
    """One KAO118 finding per unordered lock pair on a cycle, anchored
    at the later-discovered edge's site."""
    graph: dict[LockId, set[LockId]] = {}
    for e in edges:
        graph.setdefault(e.held, set()).add(e.acquired)

    def reaches(src: LockId, dst: LockId) -> bool:
        seen = {src}
        stack = [src]
        while stack:
            u = stack.pop()
            for v in graph.get(u, ()):  # noqa: B007
                if v == dst:
                    return True
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return False

    out: list[Finding] = []
    reported: set[frozenset] = set()
    for e in edges:
        pair = frozenset((e.held, e.acquired))
        if pair in reported:
            continue
        if reaches(e.acquired, e.held):
            reported.add(pair)
            out.append(Finding(
                "KAO118", e.path, e.line,
                f"lock-order cycle: {e.acquired.render()} is taken "
                f"here while {e.held.render()} is held, but the "
                "reverse order exists elsewhere in the acquisition "
                "graph — two threads running both paths deadlock; "
                "pick one global order (docs/ANALYSIS.md)"))
    return out


def file_concurrency(
    text: str, path: str, rel: str
) -> ModuleConcurrency:
    """Parse + analyze one file; syntax errors yield an empty result
    (lint_source already reports those)."""
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return ModuleConcurrency()
    return analyze_module(tree, text, path, rel)
