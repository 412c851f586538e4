"""COOPT003 — mesh-ctx scoping.

The page-range shard dispatch keys every read wrapper of
``kernels/ops.py`` off a module global (``ops._MESH_CTX``) that is read
at call time, and a CUDA graph captured under it keeps the sharded
launches. The leak class: install a ctx, run or capture a step, and
forget to restore: every LATER call (a different engine, a test, a
benchmark sharing the process) silently inherits the stale shard context
and runs each read once a shard (or, cleared, an engine's mesh steps run
unsharded). ``ops.mesh_ctx_scope`` binds a ctx for a block and restores
the previous one in ``finally``.

Contract enforced: every ``ops.set_mesh_ctx(...)`` call must be either
(a) inside the implementation itself (``set_mesh_ctx`` / the
``mesh_ctx_scope`` context manager), or (b) part of an explicit
save/restore pair in the same function — a ``saved = ops.mesh_ctx()``
capture before the install and a ``ops.set_mesh_ctx(saved)`` restore
after it (ideally in a ``finally``). Anything else — including
module-level installs — is a finding: wrap the region in
``with ops.mesh_ctx_scope(ctx):`` instead.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.core import (FileCtx, Finding, dotted_name,
                                       iter_scopes, python_files)

CODE = "COOPT003"

# functions allowed to call set_mesh_ctx directly: the primitive itself and
# the canonical scope wrapper that restores in `finally`
_IMPL_FUNCS = {"set_mesh_ctx", "mesh_ctx_scope"}


def _is_set_call(node: ast.Call) -> bool:
    name = dotted_name(node.func)
    return name is not None and name.split(".")[-1] == "set_mesh_ctx"


def _is_ctx_read(node: ast.AST) -> bool:
    """``ops.mesh_ctx()`` call or a direct ``_MESH_CTX`` read."""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        return name is not None and name.split(".")[-1] == "mesh_ctx"
    name = dotted_name(node)
    return name is not None and name.split(".")[-1] == "_MESH_CTX"


def _saved_names(fn: ast.AST) -> dict:
    """name -> lineno for ``saved = ops.mesh_ctx()`` style captures."""
    out = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _is_ctx_read(node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node.lineno
    return out


def _check_function(f: FileCtx, qual: str, fn: ast.AST,
                    out: List[Finding]) -> None:
    if qual.split(".")[-1] in _IMPL_FUNCS:
        return
    calls = [n for n in ast.walk(fn)
             if isinstance(n, ast.Call) and _is_set_call(n)]
    if not calls:
        return
    saved = _saved_names(fn)
    # restores: set_mesh_ctx(saved_name) with the capture before the restore
    restore_lines: Set[int] = set()
    for c in calls:
        if len(c.args) == 1 and isinstance(c.args[0], ast.Name) and \
                c.args[0].id in saved and saved[c.args[0].id] < c.lineno:
            restore_lines.add(c.lineno)
    for c in calls:
        if c.lineno in restore_lines:
            continue  # the restore half of a pair is always fine
        has_save_before = any(ln < c.lineno for ln in saved.values())
        has_restore_after = any(ln > c.lineno for ln in restore_lines)
        if has_save_before and has_restore_after:
            continue  # explicit save/restore pair
        out.append(Finding(
            code=CODE, path=f.path, line=c.lineno, symbol=qual,
            message=("un-scoped set_mesh_ctx call: installs a "
                     "dispatch ctx with no save/restore pair — later "
                     "calls and captures inherit the stale shards; use "
                     "`with ops.mesh_ctx_scope(ctx):` instead")))


def run(files: List[FileCtx]) -> List[Finding]:
    out: List[Finding] = []
    for f in python_files(files):
        func_spans = []
        for qual, fn, _cls in iter_scopes(f.tree):
            _check_function(f, qual, fn, out)
            func_spans.append((fn.lineno,
                               getattr(fn, "end_lineno", fn.lineno)))
        # module-level installs (outside every function) are never scoped
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Call) and _is_set_call(node) and \
                    not any(lo <= node.lineno <= hi for lo, hi in func_spans):
                out.append(Finding(
                    code=CODE, path=f.path, line=node.lineno, symbol="",
                    message=("module-level set_mesh_ctx install: the ctx "
                             "leaks into every later call and capture in "
                             "the process; bind it inside "
                             "`ops.mesh_ctx_scope` around the step")))
    return out
