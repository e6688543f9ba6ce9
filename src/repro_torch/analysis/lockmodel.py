"""Lexical lock model for the sharded data plane.

Two lock classes matter (docs/MIGRATION.md "Concurrency model"):

- the **plane** lock — ``Channel.plane``, the channel-scoped RLock that
  serializes one channel's pipeline passes; recognized as any
  ``<...>.plane`` expression;
- **stripe** locks — ``Segment.lock``, agent ``self.lock``,
  ``SwitchMemory._alloc_lock``: any Name/Attribute whose final component
  contains ``lock``.

The legal order is plane → stripe (a pipeline pass updates segments);
stripe → plane is a deadlock with the concurrent runtime. The model is
*lexical*: a lock is "held" at a node when the node sits inside a
``with <lock>:`` body, or — for the plane's explicit
``acquire(timeout=...)`` / try/finally ``release()`` idiom of
``core/rpc.py`` — anywhere after a ``.plane.acquire(...)`` call in the
same function (conservative: the repo releases in a ``finally`` at
function end, so the over-approximation is exact in practice).

Departures from ``repro.analysis.lockmodel``, each so that the same
rules read the port's idiom:

- the port takes the locks of a multi-segment transmit or reply on an
  ``ExitStack`` (``core/inc_map.py``). A ``with contextlib.ExitStack()
  as s:`` (or ``with ExitStack() as s:``) body holds the kind of each
  lock entered by ``s.enter_context(<lock expr>)``, from that call to
  the end of the ``with`` body, loops included;
- a lock's kind is read from the final attribute of its expression
  whatever the base, so ``r[0].lock`` (an entry of the port's run
  tables) is a stripe lock as ``seg.lock`` is;
- ``plane_held`` caches each function's explicit plane acquires, so a
  scan of the port stays quick; what it returns is unchanged.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.visitor import ModuleInfo, attr_chain

PLANE = "plane"
STRIPE = "stripe"


def lock_kind(expr) -> str | None:
    if isinstance(expr, ast.Attribute):
        last = expr.attr
    elif isinstance(expr, ast.Name):
        last = expr.id
    else:
        return None
    if last == "plane":
        return PLANE
    if "lock" in last.lower():
        return STRIPE
    return None


def is_plane_acquire(call: ast.Call) -> bool:
    chain = attr_chain(call.func)
    return bool(chain and len(chain) >= 2
                and chain[-2:] == ["plane", "acquire"])


def is_enter_context(call) -> bool:
    """``<x>.enter_context(<one argument>)``."""
    return (isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "enter_context" and len(call.args) == 1)


def _exit_stack_names(with_node) -> set:
    """Names bound by ``with [contextlib.]ExitStack() as s`` items."""
    names = set()
    for item in with_node.items:
        expr = item.context_expr
        if not isinstance(expr, ast.Call):
            continue
        chain = attr_chain(expr.func)
        if chain in (["ExitStack"], ["contextlib", "ExitStack"]) \
                and isinstance(item.optional_vars, ast.Name):
            names.add(item.optional_vars.id)
    return names


def _walk_same_function(stmts):
    """Every node under ``stmts`` outside nested defs and lambdas."""
    todo = list(stmts)
    while todo:
        node = todo.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                todo.append(child)


def _stack_entries(mod: ModuleInfo, with_node) -> list:
    """(enter_context call, lock kind) of each lock that the with-body
    enters on one of the ExitStacks the with-statement opens; cached."""
    cache = mod.memo.setdefault("stack_entries", {})
    if with_node not in cache:
        names = _exit_stack_names(with_node)
        entries = []
        if names:
            for sub in _walk_same_function(with_node.body):
                if is_enter_context(sub) \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id in names:
                    kind = lock_kind(sub.args[0])
                    if kind:
                        entries.append((sub, kind))
        cache[with_node] = entries
    return cache[with_node]


def _after(node, call) -> bool:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0)) \
        > (call.lineno, call.col_offset)


def held_kinds(mod: ModuleInfo, node) -> set:
    """Lock kinds held lexically at ``node`` via enclosing with-blocks,
    an ExitStack's entered locks included."""
    held = set()
    for anc, child in mod.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)) and child in anc.body:
            for item in anc.items:
                kind = lock_kind(item.context_expr)
                if kind:
                    held.add(kind)
            for call, kind in _stack_entries(mod, anc):
                if _after(node, call):
                    held.add(kind)
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            break     # a nested def is a new dynamic extent
    return held


def _plane_acquires(mod: ModuleInfo, fn) -> list:
    cache = mod.memo.setdefault("plane_acquires", {})
    if fn not in cache:
        cache[fn] = [sub for sub in ast.walk(fn)
                     if isinstance(sub, ast.Call) and is_plane_acquire(sub)
                     and mod.enclosing_function(sub) is fn]
    return cache[fn]


def plane_held(mod: ModuleInfo, node) -> bool:
    """Plane lock held at ``node``: lexical with-block, or the node sits
    after an explicit ``.plane.acquire(...)`` in the same function."""
    if PLANE in held_kinds(mod, node):
        return True
    fn = mod.enclosing_function(node)
    if fn is None:
        return False
    line = getattr(node, "lineno", 0)
    return any(sub is not node and sub.lineno < line
               for sub in _plane_acquires(mod, fn))
