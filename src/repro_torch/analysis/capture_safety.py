"""COOPT004 — capture safety of CUDA-graph step bodies.

The async pipeline captures each step shape's body once
(``_StepRunner.capture``: ``with torch.cuda.graph(...)``) and replays the
graph for every later step of that shape. A replay re-runs the captured
kernels on the captured tensors: it does not run the Python body again.
So a body that reads a module global that is later reassigned, or a
``self`` attribute that some method other than ``__init__`` stores, bakes
the value it saw at capture time (a tensor's address, a flag) into every
replay, and the replays silently compute with stale state.

Contract enforced: a captured body reads no module global reassigned
through ``global X`` in its module, and no ``self`` attribute stored (also
through an item store, ``self.x[...] = ...``) outside ``__init__``-like
scopes of its class. The bodies are the functions called directly inside
a ``with torch.cuda.graph(...)`` block (``self.body()`` -> the class's
``body``), the ``CAPTURED`` scopes below (the one hop the pass cannot
follow: ``_StepRunner.body`` calls ``Engine._async_step`` through its
engine), and every method of the same class a body calls through
``self``. State that a capture legitimately reads (a tensor allocated
once before the first capture and only updated in place afterwards) is
allowed inline with ``# coopt: allow[COOPT004]`` and its reason.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.core import (FileCtx, Finding, dotted_name,
                                       iter_scopes, python_files)

CODE = "COOPT004"

# bodies captured through another object (``runner.eng._async_step``)
CAPTURED = frozenset({"Engine._async_step"})

_INIT_SCOPES = {"__init__", "__post_init__", "setup"}
_GRAPH_CTX = {"torch.cuda.graph", "cuda.graph"}


def _mutable_globals(tree: ast.Module) -> Set[str]:
    """Module globals reassigned via ``global X`` inside some function."""
    out: Set[str] = set()
    for _q, fn, _c in iter_scopes(tree):
        declared: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Global):
                declared.update(node.names)
        if not declared:
            continue
        for node in ast.walk(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id in declared:
                    out.add(t.id)
    return out


def _base_self_attr(target) -> Optional[str]:
    while isinstance(target, ast.Subscript):
        target = target.value
    if isinstance(target, ast.Attribute) and \
            isinstance(target.value, ast.Name) and target.value.id == "self":
        return target.attr
    return None


def _self_attr_stores(fn) -> Dict[str, int]:
    """Attribute names stored on ``self`` inside ``fn`` (plain, augmented
    and item stores) -> the line of the first store."""
    out: Dict[str, int] = {}
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                a = _base_self_attr(el)
                if a and a not in out:
                    out[a] = node.lineno
    return out


def _captured_in_with(tree: ast.Module) -> Set[str]:
    """Qualnames called directly inside ``with torch.cuda.graph(...)``:
    ``self.X(...)`` -> ``Class.X``, ``f(...)`` -> ``f``."""
    out: Set[str] = set()
    for q, fn, cls in iter_scopes(tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.With) or not any(
                    isinstance(i.context_expr, ast.Call) and
                    dotted_name(i.context_expr.func) in _GRAPH_CTX
                    for i in node.items):
                continue
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                name = dotted_name(call.func) or ""
                if name.startswith("self.") and name.count(".") == 1 \
                        and cls is not None:
                    out.add(f"{cls.name}.{name[5:]}")
                elif name and "." not in name:
                    out.add(name)
    return out


def _self_calls(fn) -> Set[str]:
    return {n.func.attr for n in ast.walk(fn)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id == "self"}


def _check_body(f: FileCtx, qual: str, fn, mutable_globals: Set[str],
                cls_attrs: Set[str], out: List[Finding]) -> None:
    local: Set[str] = set()
    a = fn.args
    local.update(p.arg for p in a.posonlyargs + a.args + a.kwonlyargs)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            local.add(node.id)
    seen: Set[Tuple[str, str]] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            nm = node.id
            if nm in mutable_globals and nm not in local and \
                    ("g", nm) not in seen:
                seen.add(("g", nm))
                out.append(Finding(
                    code=CODE, path=f.path, line=node.lineno, symbol=qual,
                    message=(f"captured step body reads mutable module "
                             f"global '{nm}' (reassigned via `global "
                             f"{nm}`): every graph replay keeps its "
                             "capture-time value — pass it in as an "
                             "input")))
        elif isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and node.attr in cls_attrs and \
                ("a", node.attr) not in seen:
            seen.add(("a", node.attr))
            out.append(Finding(
                code=CODE, path=f.path, line=node.lineno, symbol=qual,
                message=(f"captured step body reads 'self.{node.attr}', "
                         "which is stored outside __init__: every graph "
                         "replay keeps the object it saw at capture — "
                         "update it in place or pass it in as an input")))


def run(files: List[FileCtx]) -> List[Finding]:
    out: List[Finding] = []
    for f in python_files(files):
        scopes = {q: (fn, cls) for q, fn, cls in iter_scopes(f.tree)}
        bodies = [q for q in _captured_in_with(f.tree) | CAPTURED
                  if q in scopes]
        if not bodies:
            continue
        mutable_globals = _mutable_globals(f.tree)
        attrs: Dict[str, Set[str]] = {}
        for q, (fn, cls) in scopes.items():
            if cls is not None and q.split(".")[-1] not in _INIT_SCOPES:
                attrs.setdefault(cls.name, set()).update(
                    _self_attr_stores(fn))
        # a body's methods called through ``self``, transitively
        todo, done = list(bodies), set()
        while todo:
            q = todo.pop()
            if q in done:
                continue
            done.add(q)
            fn, cls = scopes[q]
            _check_body(f, q, fn, mutable_globals,
                        attrs.get(cls.name, set()) if cls else set(), out)
            if cls is not None:
                todo += [f"{cls.name}.{m}" for m in _self_calls(fn)
                         if f"{cls.name}.{m}" in scopes]
    return out
