"""COOPT001 — host-sync discipline on the serving step path.

The async pipeline (``serving.frontend``) overlaps host plan-building with
the card's work only because one code path blocks on device values: the
emit worker, which waits on its ring slot's event and reads the slot's
tokens. Any other ``.item()`` / ``.cpu()`` / ``.tolist()`` / ``.numpy()`` /
``float(t)`` / ``int(t)`` of a device tensor, ``torch.cuda.synchronize``
or an event's ``.synchronize()`` on the step path re-serializes the
pipeline: the host stalls, the card starves, and the dispatch-depth-2 win
silently evaporates. A sync inside a CUDA-graph capture also breaks the
capture.

Contract enforced: inside the serving modules (``serving/engine.py``,
``serving/frontend.py``) every host-sync pattern must live in one of the
ALLOWED scopes below, each with its reason. Anything else is a finding:
move the sync to the emit worker, keep the value on the device, or, if the
call touches host values only, add an inline ``# coopt: allow[COOPT001]``
with a rationale (canonical example: ``EngineStats._pct``, which applies
``float``/``np.asarray`` to host-side Python lists).

A static pass cannot see a value's device: ``float(x)`` and ``int(x)`` are
flagged unless ``x`` is a constant or a call that returns a host value
(``len``, ``np.*``, ``math.*``).
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.core import (FileCtx, Finding, dotted_name,
                                       enclosing_index, python_files,
                                       scope_of)

CODE = "COOPT001"

# modules under the host-sync contract (matched by path suffix)
CHECKED_SUFFIXES = ("serving/engine.py", "serving/frontend.py")

# scope -> why a host sync is part of the design there, not a stall
ALLOWED_SCOPES = {
    # setup / teardown — never on the per-step path
    "Engine.__init__": "setup",
    "Engine.warmup": "setup: the lattice's eager runs and captures, then "
                     "a sync before serving",
    "Engine._dummy_batch": "setup",
    "Engine._warmup_lattice": "setup",
    "AsyncEngine.__init__": "setup",
    "AsyncEngine.close": "teardown",
    # the synchronous loop's designated host boundary: _execute blocks on
    # the step it just ran, _sample converts its logits' samples
    "Engine._execute": "the sync loop's host boundary",
    "Engine._sample": "the sync loop's host boundary",
    # client API — coerces caller-provided host prompts, stamps times
    "Engine.generate": "client API, host prompts",
    "Engine.add_request": "client API",
    "AsyncEngine.submit": "client API, host prompts",
    # THE async host sync: the emit worker owns the only blocking read
    "AsyncEngine._emit_worker": "the async pipeline's one host sync",
    # the port's step runner stages a step's host arrays in a pinned host
    # buffer; ``.numpy()`` there is a view of host memory, not a sync
    "_StepRunner.load": "host staging buffer, no device value",
    # the loop thread turns the tokens the emit worker already read into
    # emitted tokens: host numpy arrays
    "AsyncEngine._drain_done": "host tokens the emit worker read",
    "Engine._postprocess": "host tokens the sync loop read",
    # the stats' report: host counters, no device value
    "EngineStats.latency_summary": "host counters",
}

# call patterns that force a device->host sync when fed a device value
_SYNC_FUNCS = {"torch.cuda.synchronize", "np.asarray", "numpy.asarray",
               "np.array", "numpy.array"}
_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
_HOST_CALLS = ("np.", "numpy.", "math.")


def _is_checked(path: str) -> bool:
    return any(path.endswith(s) for s in CHECKED_SUFFIXES)


def _host_value(node: ast.AST) -> bool:
    """A constant, or a call whose result lives on the host."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Call):
        name = dotted_name(node.func) or ""
        return name == "len" or name.startswith(_HOST_CALLS)
    return False


def _sync_kind(node: ast.Call):
    """Return a description if this call matches a sync pattern."""
    fn = node.func
    name = dotted_name(fn)
    if name in _SYNC_FUNCS:
        return f"{name}(...)"
    if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS \
            and not isinstance(fn.value, ast.Constant):
        return f".{fn.attr}()"
    if isinstance(fn, ast.Name) and fn.id in ("float", "int") and \
            node.args and not _host_value(node.args[0]):
        return f"{fn.id}(...)"
    return None


def run(files: List[FileCtx]) -> List[Finding]:
    out: List[Finding] = []
    for f in python_files(files):
        if not _is_checked(f.path):
            continue
        index = enclosing_index(f.tree)
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _sync_kind(node)
            if kind is None:
                continue
            scope = scope_of(index, node.lineno)
            if scope in ALLOWED_SCOPES:
                continue
            out.append(Finding(
                code=CODE, path=f.path, line=node.lineno, symbol=scope,
                message=(f"host sync {kind} on the serving step path "
                         f"(scope {scope or '<module>'}): only "
                         "AsyncEngine._emit_worker (async) and "
                         "Engine._execute/_sample (sync loop) may block "
                         "on device values")))
    return out
