"""COOPT006 — no swallowed exceptions on serving fault paths.

The resilience layer's whole contract is that faults PROPAGATE —
a step exception drains the pipeline as ERROR, an emit-worker fault is
posted to the loop, a stall raises ``PipelineStallError``. One
``except: pass`` in a serving loop or worker turns any of those into a
silent hang: the stream never closes, the client blocks forever, and the
chaos suite's "every stream terminates with the correct FinishReason"
guarantee dies. (The canonical near-miss: a blanket handler around the
emit worker's host sync that drops the exception instead of posting it —
the watchdog then reports a stall instead of the real fault.)

Contract enforced: inside ``serving/`` modules, a BLANKET handler — bare
``except:``, ``except Exception``, or ``except BaseException`` — must
either re-raise or USE the exception it bound (pass it somewhere, attach
it, post it); binding nothing, or binding ``as exc`` and never reading
it, is a finding. Narrow handlers (``queue.Empty``, ``OutOfBlocks``, ...)
are policy, not swallowing, and pass untouched. A deliberate blanket
swallow needs an inline ``# coopt: allow[COOPT006]`` rationale.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import (FileCtx, Finding, dotted_name,
                                       enclosing_index, python_files,
                                       scope_of)

CODE = "COOPT006"

# modules under the fault-propagation contract (matched by path segment)
CHECKED_SEGMENT = "serving/"

_BLANKET = {"Exception", "BaseException"}


def _is_checked(path: str) -> bool:
    return CHECKED_SEGMENT in path


def _blanket_kind(handler: ast.ExceptHandler):
    """'' for bare except, the type name for Exception/BaseException (also
    inside a tuple), None for narrow handlers."""
    t = handler.type
    if t is None:
        return ""
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        name = dotted_name(node)
        if name in _BLANKET:
            return name
    return None


def _handler_propagates(handler: ast.ExceptHandler) -> bool:
    """True if the handler re-raises or reads the exception it bound."""
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if (handler.name is not None and isinstance(node, ast.Name)
                    and node.id == handler.name
                    and isinstance(node.ctx, ast.Load)):
                return True
    return False


def run(files: List[FileCtx]) -> List[Finding]:
    out: List[Finding] = []
    for f in python_files(files):
        if not _is_checked(f.path):
            continue
        index = enclosing_index(f.tree)
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            kind = _blanket_kind(node)
            if kind is None or _handler_propagates(node):
                continue
            what = "bare except:" if kind == "" else f"except {kind}"
            scope = scope_of(index, node.lineno)
            out.append(Finding(
                code=CODE, path=f.path, line=node.lineno, symbol=scope,
                message=(f"{what} swallows exceptions on a serving fault "
                         f"path (scope {scope or '<module>'}): re-raise "
                         "or use the bound exception — faults must "
                         "propagate or be recorded, never vanish")))
    return out
