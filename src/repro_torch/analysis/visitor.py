"""Shared AST plumbing: one parsed module, parent links, scope names,
attribute-chain helpers, obs-alias and env-constant tables.

Everything downstream (lockmodel, rules) works off a ``ModuleInfo`` so
each file is parsed exactly once per run.

Departure from ``repro.analysis.visitor``: the obs package whose aliases
mark observability calls is ``repro_torch.obs``, the port's, so rule O1
sees ``_obs``, ``_trace`` and ``_metrics`` in the port's hot modules.
``ModuleInfo.nodes`` keeps the one walk of the tree (in ``ast.walk``'s
order) that every rule iterates, so a scan of the port stays quick.
"""
from __future__ import annotations

import ast

from repro_torch.analysis import pragmas
from repro_torch.analysis.findings import canon_path

# repro_torch.obs submodules whose aliases mark observability calls (O1)
_OBS_PACKAGE = "repro_torch.obs"


class ModuleInfo:
    def __init__(self, path: str, source: str):
        self.path = canon_path(path)
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.suppressions = pragmas.scan(self.path, source)
        self.nodes = list(ast.walk(self.tree))     # walked once, BFS order
        for node in self.nodes:
            for child in ast.iter_child_nodes(node):
                child._pl_parent = node
        self.obs_aliases = _collect_obs_aliases(self.nodes)
        self.env_constants = _collect_env_constants(self.tree)
        self.memo: dict = {}    # lockmodel's per-module caches

    # -- ancestry ---------------------------------------------------------

    def parent(self, node):
        return getattr(node, "_pl_parent", None)

    def ancestors(self, node):
        """Yields (ancestor, immediate_child_on_the_path) pairs walking
        from ``node``'s parent up to the Module."""
        child, cur = node, self.parent(node)
        while cur is not None:
            yield cur, child
            child, cur = cur, self.parent(cur)

    def enclosing_function(self, node):
        for anc, _ in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def enclosing_class(self, node):
        for anc, _ in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return None       # a def between node and the class
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    def scope_of(self, node) -> str:
        parts = []
        for anc, _ in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(anc.name)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            parts.insert(0, node.name)
        return ".".join(reversed(parts)) or "<module>"


def attr_chain(node) -> list | None:
    """["channel", "plane", "acquire"] for ``channel.plane.acquire`` —
    None when the expression is not a pure Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


def decorator_names(fn) -> set:
    names = set()
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        chain = attr_chain(target)
        if chain:
            names.add(chain[-1])
    return names


def call_kwarg(call: ast.Call, name: str):
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


def _collect_obs_aliases(nodes) -> dict:
    aliases = {}
    for node in nodes:
        if isinstance(node, ast.ImportFrom):
            if node.module == _OBS_PACKAGE:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{_OBS_PACKAGE}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(_OBS_PACKAGE + ".") and a.asname:
                    aliases[a.asname] = a.name
    return aliases


def _collect_env_constants(tree) -> dict:
    """Module-level ``_ENV = "REPRO_..."`` string constants, so E1 can
    resolve ``os.environ.get(_ENV)`` through the indirection."""
    consts = {}
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                and isinstance(stmt.targets[0], ast.Name) \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, str) \
                and stmt.value.value.startswith("REPRO_"):
            consts[stmt.targets[0].id] = stmt.value.value
    return consts
