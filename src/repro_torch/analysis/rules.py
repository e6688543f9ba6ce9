"""The plane-invariant rules.

Each rule is a function ``ModuleInfo -> list[Finding]`` registered in
``RULES``. The invariants encode the concurrency/observability contract
of PRs 5-7 (see docs/ANALYSIS.md for the catalog):

  L1  segment/switch state mutated only under its stripe lock
  L2  lock ordering (plane before stripe) + no blocking under the plane
  L3  agent public mutators carry @_locked
  O1  obs calls in hot paths sit behind a hooks guard
  E1  REPRO_* env vars read once at import, never per call
  S1  schema-surfaced options handled or rejected with SchemaError
  D1  dead code: unused imports, unreachable statements

Departures from ``repro.analysis.rules``, each so that the same rule
reads the port's idiom:

- L1 (and L3, which shares the mutation extraction) also sees the two
  ways the port writes state without rebinding it: a torch in-place
  method (a name ending in one ``_``: ``copy_``, ``zero_``, ``add_``,
  ...) on the attribute or on a subscript of it, and the attribute
  passed, directly or inside a tuple, list or comprehension element, to
  a wrapper of ``kernels/ops.py`` that writes its register argument in
  place and returns none (``INPLACE_KERNEL_WRAPPERS``);
- L2's ordering check also reads a plane lock entered on an
  ``ExitStack`` (``s.enter_context(ch.plane)``) while a stripe lock is
  held (see ``lockmodel``).
"""
from __future__ import annotations

import ast

from repro_torch.analysis import lockmodel
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.visitor import (ModuleInfo, attr_chain, call_kwarg,
                                    decorator_names)

# ---------------------------------------------------------------------------
# shared vocabulary

# switch-memory / agent map state protected by stripe locks (L1)
PROTECTED_ATTRS = frozenset(
    {"regs", "mapping", "spill", "partitions", "_next_free"})

# method names that mutate their receiver in place
MUTATING_METHODS = frozenset(
    {"append", "extend", "insert", "pop", "popitem", "clear", "update",
     "setdefault", "remove", "discard", "add", "sort", "reverse",
     "appendleft", "popleft"})

# kernels/ops.py wrappers that write the register files they are given in
# place and return none, so the caller never rebinds the attribute:
# name -> (position, keyword) of the argument that holds the registers
INPLACE_KERNEL_WRAPPERS = {"device_addto_dense_runs": (0, "runs")}

# constructors/initializers run before the object is shared
_INIT_FUNCS = frozenset({"__init__", "__post_init__", "__new__"})

# obs callees that are cold-path exports/controls, not per-event records
_OBS_COLD_CALLEES = frozenset(
    {"snapshot", "chrome_trace", "prometheus_text", "reset", "enable",
     "disable", "enabled", "set_tracing"})

# modules whose obs calls must be guarded (the data-plane hot paths)
_HOT_SUFFIXES = ("core/rpc.py", "core/runtime.py", "core/inc_map.py")


def _is_hot_path(path: str) -> bool:
    return path.endswith(_HOT_SUFFIXES) or "kernels/" in path


def _in_init(mod: ModuleInfo, node) -> bool:
    fn = mod.enclosing_function(node)
    return fn is not None and fn.name in _INIT_FUNCS


def _is_private_method(mod: ModuleInfo, node) -> bool:
    fn = mod.enclosing_function(node)
    return (fn is not None and fn.name.startswith("_")
            and not fn.name.startswith("__"))


def _has_locked_decorator(mod: ModuleInfo, node) -> bool:
    fn = mod.enclosing_function(node)
    return fn is not None and "_locked" in decorator_names(fn)


# ---------------------------------------------------------------------------
# mutation extraction (shared by L1 and L3)

def _is_inplace_method(name: str) -> bool:
    """A torch in-place method: ``add_``, ``copy_``; not ``__x__``."""
    return len(name) > 1 and name.endswith("_") and not name.endswith("__")


def _passed_attrs(expr):
    """Attributes passed as ``expr``: the attribute itself, or one inside
    a tuple, list or comprehension element."""
    if isinstance(expr, ast.Attribute):
        yield expr, expr.attr
    elif isinstance(expr, (ast.Tuple, ast.List)):
        for el in expr.elts:
            yield from _passed_attrs(el)
    elif isinstance(expr, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
        yield from _passed_attrs(expr.elt)


def _mutated_attrs(node):
    """Yields (attr_node, attr_name) for every attribute the statement
    mutates directly: ``x.a = / += / del``, ``x.a[i] =``, ``x.a.pop()``,
    ``x.a.copy_(v)``, ``x.a[i].zero_()``, ``ops.device_addto_dense_runs(
    [(x.a, ...)], ...)``."""
    targets = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    elif isinstance(node, ast.Delete):
        targets = node.targets
    elif isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr in MUTATING_METHODS \
            and isinstance(node.func.value, ast.Attribute):
        yield node.func.value, node.func.value.attr
        return
    elif isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and _is_inplace_method(node.func.attr):
        recv = node.func.value
        if isinstance(recv, ast.Subscript):
            recv = recv.value
        if isinstance(recv, ast.Attribute):
            yield recv, recv.attr
        return
    elif isinstance(node, ast.Call):
        chain = attr_chain(node.func)
        if chain and chain[-1] in INPLACE_KERNEL_WRAPPERS:
            pos, name = INPLACE_KERNEL_WRAPPERS[chain[-1]]
            kw = call_kwarg(node, name)
            arg = node.args[pos] if len(node.args) > pos \
                else kw.value if kw is not None else None
            if arg is not None:
                yield from _passed_attrs(arg)
        return
    for t in targets:
        for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
            if isinstance(el, ast.Attribute):
                yield el, el.attr
            elif isinstance(el, ast.Subscript) \
                    and isinstance(el.value, ast.Attribute):
                yield el.value, el.value.attr


# ---------------------------------------------------------------------------
# L1 — stripe-locked state

def check_l1(mod: ModuleInfo) -> list:
    out = []
    for node in mod.nodes:
        for attr_node, name in _mutated_attrs(node):
            if name not in PROTECTED_ATTRS:
                continue
            if _in_init(mod, node) or _has_locked_decorator(mod, node) \
                    or _is_private_method(mod, node):
                # private helpers run under the public caller's lock —
                # the public surface is what L1/L3 police
                continue
            if lockmodel.STRIPE in lockmodel.held_kinds(mod, node):
                continue
            out.append(Finding(
                "L1", mod.path, node.lineno, mod.scope_of(node), name,
                f"mutation of protected plane state '.{name}' outside "
                f"its stripe lock — wrap in 'with <owner>.lock:' or mark "
                f"the method @_locked"))
    return out


# ---------------------------------------------------------------------------
# L2 — lock ordering and blocking under the plane

_BLOCKING_NEEDS_TIMEOUT = frozenset({"join", "wait"})


def _has_timeout(call: ast.Call) -> bool:
    return bool(call.args) or call_kwarg(call, "timeout") is not None


def check_l2(mod: ModuleInfo) -> list:
    out = []
    for node in mod.nodes:
        # (a) ordering: a `with <x>.plane:` opened while a stripe lock is
        # already held inverts the plane→stripe order
        if lockmodel.is_enter_context(node) \
                and lockmodel.lock_kind(node.args[0]) == lockmodel.PLANE \
                and lockmodel.STRIPE in lockmodel.held_kinds(mod, node):
            out.append(Finding(
                "L2", mod.path, node.lineno, mod.scope_of(node),
                "plane-after-stripe",
                "plane lock acquired while holding a stripe lock — the "
                "legal order is plane → stripe"))
            continue
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if lockmodel.lock_kind(item.context_expr) \
                        == lockmodel.PLANE \
                        and lockmodel.STRIPE \
                        in lockmodel.held_kinds(mod, node):
                    out.append(Finding(
                        "L2", mod.path, node.lineno, mod.scope_of(node),
                        "plane-after-stripe",
                        "plane lock acquired while holding a stripe "
                        "lock — the legal order is plane → stripe"))
            continue
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        # (c) every explicit plane acquire carries a timeout, so a handler
        # cycle surfaces as the named RuntimeError, never a silent hang
        if lockmodel.is_plane_acquire(node):
            if not _has_timeout(node):
                out.append(Finding(
                    "L2", mod.path, node.lineno, mod.scope_of(node),
                    "plane.acquire",
                    "plane lock acquired without a timeout — use "
                    "acquire(timeout=PLANE_LOCK_TIMEOUT) so a handler "
                    "cycle raises instead of deadlocking"))
            # (a) ordering: plane taken while a stripe lock is held
            if lockmodel.STRIPE in lockmodel.held_kinds(mod, node):
                out.append(Finding(
                    "L2", mod.path, node.lineno, mod.scope_of(node),
                    "plane-after-stripe",
                    "plane lock acquired while holding a stripe lock — "
                    "the legal order is plane → stripe"))
            continue
        if not chain:
            continue
        callee = chain[-1]
        if callee == "release":
            continue
        # (b) blocking calls while the plane is held stall every pass on
        # the channel (and a .result() wait deadlocks the drain worker)
        if not lockmodel.plane_held(mod, node):
            continue
        if callee in ("result", "drain"):
            out.append(Finding(
                "L2", mod.path, node.lineno, mod.scope_of(node),
                f".{callee}()",
                f"blocking '.{callee}()' while the plane lock is held — "
                f"move the wait outside the pipeline pass"))
        elif callee in _BLOCKING_NEEDS_TIMEOUT and not _has_timeout(node):
            out.append(Finding(
                "L2", mod.path, node.lineno, mod.scope_of(node),
                f".{callee}()",
                f"unbounded '.{callee}()' while the plane lock is held — "
                f"pass a timeout or move it off the pass"))
        elif callee == "acquire" and not _has_timeout(node):
            out.append(Finding(
                "L2", mod.path, node.lineno, mod.scope_of(node),
                ".acquire()",
                "untimed lock acquire while the plane lock is held — "
                "nested acquisition under the plane needs a timeout"))
        elif callee in ("get", "put") \
                and any("queue" in part.lower() for part in chain[:-1]) \
                and not _has_timeout(node) \
                and call_kwarg(node, "block") is None:
            out.append(Finding(
                "L2", mod.path, node.lineno, mod.scope_of(node),
                f".{callee}()",
                f"queue .{callee}() wait while the plane lock is held"))
    return out


# ---------------------------------------------------------------------------
# L3 — agent public mutators are @_locked

def _lock_owning_classes(mod: ModuleInfo):
    for node in mod.nodes:
        if not isinstance(node, ast.ClassDef):
            continue
        for fn in node.body:
            if isinstance(fn, ast.FunctionDef) and fn.name in _INIT_FUNCS:
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Assign):
                        for t in sub.targets:
                            if isinstance(t, ast.Attribute) \
                                    and t.attr == "lock" \
                                    and isinstance(t.value, ast.Name) \
                                    and t.value.id == "self":
                                yield node
                                break


def check_l3(mod: ModuleInfo) -> list:
    out = []
    for cls in set(_lock_owning_classes(mod)):
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            if fn.name.startswith("_"):
                continue        # private/dunder: runs under a caller's lock
            if "_locked" in decorator_names(fn):
                continue
            for node in ast.walk(fn):
                hits = [
                    (attr_node, name)
                    for attr_node, name in _mutated_attrs(node)
                    if isinstance(attr_node.value, ast.Name)
                    and attr_node.value.id == "self"]
                if not hits:
                    continue
                if lockmodel.STRIPE in lockmodel.held_kinds(mod, node):
                    continue    # inline 'with self.lock:' is equivalent
                name = hits[0][1]
                out.append(Finding(
                    "L3", mod.path, node.lineno,
                    f"{cls.name}.{fn.name}", name,
                    f"public method {cls.name}.{fn.name} mutates "
                    f"'self.{name}' without @_locked (the class owns "
                    f"'self.lock') — decorate it or take the lock "
                    f"inline"))
                break           # one finding per method is enough
    return out


# ---------------------------------------------------------------------------
# O1 — obs purity on hot paths

def _mentions_guard(mod: ModuleInfo, expr, tainted: set) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name) and sub.id in tainted:
            return True
        if isinstance(sub, ast.Attribute):
            chain = attr_chain(sub)
            if chain and chain[0] in mod.obs_aliases:
                return True
    return False


def _guarded(mod: ModuleInfo, node, tainted: set) -> bool:
    """True when ``node`` only executes because an obs guard was taken:
    inside the body of ``if <guard>:``, the true branch of a guard IfExp,
    or short-circuited behind a guard in ``guard and <node>``."""
    for anc, child in mod.ancestors(node):
        if isinstance(anc, ast.If) and child in anc.body \
                and _mentions_guard(mod, anc.test, tainted):
            return True
        if isinstance(anc, ast.IfExp) and child is anc.body \
                and _mentions_guard(mod, anc.test, tainted):
            return True
        if isinstance(anc, ast.BoolOp) and isinstance(anc.op, ast.And):
            if child in anc.values:
                ix = anc.values.index(child)
                if any(_mentions_guard(mod, v, tainted)
                       for v in anc.values[:ix]):
                    return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break
    return False


def _tainted_names(mod: ModuleInfo, fn) -> set:
    """Local names carrying an obs-guard value (``trc = _obs.TRACE and
    ...``, ``ctx = _trace.maybe_start(...) if _obs.TRACE else None``, or
    any assignment inside a guarded branch). Fixpoint over assignments so
    ordering doesn't matter."""
    tainted: set = set()
    for _ in range(4):
        before = len(tainted)
        for node in ast.walk(fn):
            value, targets = None, []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.NamedExpr):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AugAssign):
                value, targets = node.value, [node.target]
            if value is None:
                continue
            if _mentions_guard(mod, value, tainted) \
                    or _guarded(mod, node, tainted):
                for t in targets:
                    for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                               else [t]):
                        if isinstance(el, ast.Name):
                            tainted.add(el.id)
        if len(tainted) == before:
            break
    return tainted


def check_o1(mod: ModuleInfo) -> list:
    if not _is_hot_path(mod.path) or not mod.obs_aliases:
        return []
    out = []
    taint_cache: dict = {}
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        if not chain or len(chain) < 2 or chain[0] not in mod.obs_aliases:
            continue
        if chain[-1] in _OBS_COLD_CALLEES:
            continue            # export/control surface, not a hot record
        fn = mod.enclosing_function(node)
        if fn is not None and fn.name.endswith("_observed"):
            continue            # the instrumented twin is obs by contract
        tainted = set()
        if fn is not None:
            if fn not in taint_cache:
                taint_cache[fn] = _tainted_names(mod, fn)
            tainted = taint_cache[fn]
        if _guarded(mod, node, tainted):
            continue
        detail = ".".join(chain)
        out.append(Finding(
            "O1", mod.path, node.lineno, mod.scope_of(node), detail,
            f"unguarded obs call '{detail}(...)' on a data-plane hot "
            f"path — gate it behind 'if _obs.METRICS:' / 'if "
            f"_obs.TRACE:' or move it into an *_observed variant"))
    return out


# ---------------------------------------------------------------------------
# E1 — env vars read once at import

def _env_key(mod: ModuleInfo, arg) -> str | None:
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str) \
            and arg.value.startswith("REPRO_"):
        return arg.value
    if isinstance(arg, ast.Name):
        return mod.env_constants.get(arg.id)
    return None


def _env_reads(mod: ModuleInfo):
    """Yields (node, env_var) for every keyed REPRO_* environment read:
    ``os.environ.get(K)``, ``os.getenv(K)``, ``os.environ[K]`` (Load)."""
    for node in mod.nodes:
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if not chain or not node.args:
                continue
            keyed = (chain[-1] == "getenv"
                     or (len(chain) >= 2 and chain[-2] == "environ"
                         and chain[-1] == "get"))
            if keyed:
                key = _env_key(mod, node.args[0])
                if key:
                    yield node, key
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load):
            chain = attr_chain(node.value)
            if chain and chain[-1] == "environ":
                key = _env_key(mod, node.slice)
                if key:
                    yield node, key


def check_e1(mod: ModuleInfo) -> list:
    out = []
    for node, key in _env_reads(mod):
        if mod.enclosing_function(node) is None:
            continue            # module/config init time: the E1 contract
        out.append(Finding(
            "E1", mod.path, node.lineno, mod.scope_of(node), key,
            f"per-call read of ${key} — REPRO_* env vars are read once "
            f"at module/config initialization; hoist to a module-level "
            f"constant"))
    return out


# ---------------------------------------------------------------------------
# S1 — schema options handled or rejected

def check_s1(mod: ModuleInfo) -> list:
    out = []
    options_nodes = []
    for node in mod.nodes:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "_OPTIONS" \
                and isinstance(node.value, ast.Dict) \
                and mod.enclosing_class(node) is not None:
            options_nodes.append(node)
    if not options_nodes:
        return []
    surfaced: dict[str, ast.Assign] = {}
    inside = set()
    for node in options_nodes:
        for sub in ast.walk(node):
            inside.add(id(sub))
        for values in node.value.values:
            for el in getattr(values, "elts", []):
                if isinstance(el, ast.Constant) \
                        and isinstance(el.value, str):
                    surfaced.setdefault(el.value, node)
    handled = set()
    rejects = False
    for sub in mod.nodes:
        if id(sub) in inside:
            continue
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            handled.add(sub.value)
        elif isinstance(sub, ast.Attribute):
            handled.add(sub.attr)
        elif isinstance(sub, ast.Raise):
            exc = sub.exc
            target = exc.func if isinstance(exc, ast.Call) else exc
            chain = attr_chain(target) if target is not None else None
            if chain and chain[-1].endswith("Error"):
                rejects = True
    for opt, node in sorted(surfaced.items()):
        if opt not in handled:
            out.append(Finding(
                "S1", mod.path, node.lineno, mod.scope_of(node), opt,
                f"schema option '{opt}' is surfaced by _OPTIONS but "
                f"never handled in this module — consume it in compile "
                f"or drop it from the annotation surface"))
    if surfaced and not rejects:
        node = options_nodes[0]
        out.append(Finding(
            "S1", mod.path, node.lineno, mod.scope_of(node),
            "<no-rejection>",
            "a class surfaces _OPTIONS but the module never raises a "
            "named *Error — unknown options must be rejected loudly"))
    return out


# ---------------------------------------------------------------------------
# D1 — dead code

_TERMINATORS = (ast.Return, ast.Raise, ast.Break, ast.Continue)


def _imported_names(node):
    if isinstance(node, ast.Import):
        for a in node.names:
            yield (a.asname or a.name.split(".")[0]), a.name
    elif isinstance(node, ast.ImportFrom):
        if node.module == "__future__":
            return
        for a in node.names:
            if a.name == "*":
                continue
            yield (a.asname or a.name), a.name


def check_d1(mod: ModuleInfo) -> list:
    out = []
    if not mod.path.endswith("__init__.py"):
        bound: list[tuple[str, str, ast.AST]] = []
        for node in mod.nodes:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for local, orig in _imported_names(node):
                    bound.append((local, orig, node))
        used, exported = set(), set()
        for node in mod.nodes:
            if isinstance(node, ast.Name) \
                    and not isinstance(node.ctx, ast.Store):
                used.add(node.id)
            elif isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in node.targets):
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Constant) \
                            and isinstance(sub.value, str):
                        exported.add(sub.value)
        for local, orig, node in bound:
            if local in used or local in exported or local == "_":
                continue
            out.append(Finding(
                "D1", mod.path, node.lineno, mod.scope_of(node), local,
                f"unused import '{local}'"
                + (f" (from '{orig}')" if orig != local else "")
                + " — remove it, or mark an intentional side-effect/"
                "re-export with '# noqa'"))
    for node in mod.nodes:
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            for i, stmt in enumerate(stmts[:-1]):
                if isinstance(stmt, _TERMINATORS):
                    nxt = stmts[i + 1]
                    out.append(Finding(
                        "D1", mod.path, nxt.lineno, mod.scope_of(nxt),
                        "unreachable",
                        f"unreachable statement after "
                        f"'{type(stmt).__name__.lower()}'"))
                    break
    return out


# ---------------------------------------------------------------------------

RULES = {
    "L1": (check_l1, "segment/switch state mutated only under its "
                     "stripe lock or an @_locked method"),
    "L2": (check_l2, "lock order plane→stripe; no blocking call and no "
                     "untimed acquire while the plane is held"),
    "L3": (check_l3, "public mutators of lock-owning agents carry "
                     "@_locked"),
    "O1": (check_o1, "obs calls on hot paths are guarded or live in "
                     "*_observed variants"),
    "E1": (check_e1, "REPRO_* env vars read once at import, never "
                     "per call"),
    "S1": (check_s1, "schema-surfaced options are handled or rejected "
                     "with a named error"),
    "D1": (check_d1, "no unused imports or unreachable statements"),
}


def run_rules(mod: ModuleInfo, only: set | None = None) -> list:
    findings = []
    for rule, (fn, _) in RULES.items():
        if only is not None and rule not in only:
            continue
        findings.extend(fn(mod))
    return findings
