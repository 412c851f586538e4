"""cooptlint infrastructure: findings, file contexts, inline suppression,
the committed baseline, and the pass runner.

Design notes:

  * Passes receive the WHOLE file set (``List[FileCtx]``), not one file at
    a time: Python sources (parsed, ``tree`` set) and the CUDA sources of
    ``kernels/csrc`` (``.cu``/``.cuh``, ``tree`` None), which only the
    page-guard pass (COOPT005) reads.
  * Baseline entries match on ``(code, path, symbol, message)`` — line
    numbers drift under refactors, so they are recorded for humans but
    ignored for matching. Every entry carries a ``justification``.
  * Inline suppression is comment-based (``# coopt: allow[CODE]``, or
    ``// coopt: allow[CODE]`` in CUDA) on the finding's line or the line
    directly above, so the rationale lives next to the code it excuses.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_ALLOW_RE = re.compile(r"(?:#|//)\s*coopt:\s*allow\[([A-Z0-9_,\s]+)\]")


@dataclass(frozen=True)
class Finding:
    code: str                  # stable pass code, e.g. "COOPT001"
    path: str                  # repo-relative posix path
    line: int                  # 1-based line of the offending node
    symbol: str                # enclosing qualname, e.g. "Engine._sample"
    message: str               # one-line description of the violation

    def match_key(self) -> Tuple[str, str, str, str]:
        """Baseline identity — line numbers excluded (they drift)."""
        return (self.code, self.path, self.symbol, self.message)

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclass
class FileCtx:
    """One parsed source file handed to every pass."""
    path: str                  # repo-relative posix path
    source: str
    tree: Optional[ast.Module]     # None for a CUDA source
    lines: List[str] = field(default_factory=list)
    # line -> frozenset of allowed codes (from `# coopt: allow[...]`)
    allows: Dict[int, frozenset] = field(default_factory=dict)

    @classmethod
    def parse(cls, abspath: str, relpath: str) -> "FileCtx":
        with open(abspath, "r", encoding="utf-8") as f:
            src = f.read()
        tree = (ast.parse(src, filename=relpath)
                if relpath.endswith(".py") else None)
        lines = src.splitlines()
        allows: Dict[int, frozenset] = {}
        for i, ln in enumerate(lines, start=1):
            m = _ALLOW_RE.search(ln)
            if m:
                codes = frozenset(c.strip() for c in m.group(1).split(",")
                                  if c.strip())
                allows[i] = codes
        return cls(path=relpath, source=src, tree=tree, lines=lines,
                   allows=allows)

    def suppressed(self, code: str, line: int) -> bool:
        """A finding at ``line`` is suppressed by an allow marker on the
        same line or the line directly above it."""
        for ln in (line, line - 1):
            if code in self.allows.get(ln, frozenset()):
                return True
        return False


def python_files(files: Sequence["FileCtx"]) -> List["FileCtx"]:
    return [f for f in files if f.tree is not None]


# ------------------------------------------------------------- AST helpers --
def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def iter_scopes(tree: ast.Module):
    """Yield ``(qualname, func_node, class_node_or_None)`` for every
    function/method in the module, including nested ones."""

    def walk(node, prefix: str, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child, cls
                yield from walk(child, q + ".", cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", child)

    yield from walk(tree, "", None)


def enclosing_index(tree: ast.Module) -> List[Tuple[str, int, int]]:
    """(qualname, first_line, last_line) per scope, innermost resolvable
    via :func:`scope_of`."""
    out = []
    for q, fn, _ in iter_scopes(tree):
        out.append((q, fn.lineno, max(fn.lineno,
                                      getattr(fn, "end_lineno", fn.lineno))))
    return out


def scope_of(index: List[Tuple[str, int, int]], line: int) -> str:
    """Innermost scope qualname containing ``line`` ('' = module level)."""
    best, best_span = "", None
    for q, lo, hi in index:
        if lo <= line <= hi:
            span = hi - lo
            if best_span is None or span <= best_span:
                best, best_span = q, span
    return best


# ---------------------------------------------------------------- baseline --
def load_baseline(path: str) -> List[Dict[str, object]]:
    if not path or not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return list(data.get("findings", []))


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = [{"code": f.code, "path": f.path, "symbol": f.symbol,
                "message": f.message, "line": f.line,
                "justification": "TODO: justify or fix"}
               for f in findings]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"comment": "cooptlint grandfathered findings; every "
                              "entry needs a one-line justification",
                   "findings": entries}, f, indent=2)
        f.write("\n")


def baseline_keys(entries: Iterable[Dict[str, object]]):
    return {(str(e.get("code")), str(e.get("path")), str(e.get("symbol")),
             str(e.get("message"))) for e in entries}


# ------------------------------------------------------------------ runner --
_SUFFIXES = (".py", ".cu", ".cuh")


def collect_files(paths: Sequence[str],
                  root: Optional[str] = None) -> List[FileCtx]:
    root = root or os.getcwd()
    out: List[FileCtx] = []
    seen = set()
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for fn in sorted(filenames):
                    if fn.endswith(_SUFFIXES):
                        fp = os.path.join(dirpath, fn)
                        if fp not in seen:
                            seen.add(fp)
                            out.append(_parse_one(fp, root))
        elif ap.endswith(_SUFFIXES):
            if ap not in seen:
                seen.add(ap)
                out.append(_parse_one(ap, root))
    return out


def _parse_one(abspath: str, root: str) -> FileCtx:
    rel = os.path.relpath(abspath, root)
    return FileCtx.parse(abspath, rel.replace(os.sep, "/"))


def all_passes():
    """The registered passes, in code order. Imported lazily so a syntax
    error in one pass module names itself instead of breaking import of
    the package."""
    from repro_torch.analysis import (capture_safety, exceptions, host_sync,
                                      mesh_ctx, page_guard)
    return [host_sync, mesh_ctx, capture_safety, page_guard, exceptions]


def run_suite(paths: Sequence[str], *, root: Optional[str] = None,
              select: Optional[Sequence[str]] = None,
              baseline_path: Optional[str] = None):
    """Run every (selected) pass over ``paths``.

    Returns ``(findings, suppressed, baselined, kernel_report)`` where
    ``findings`` are the live violations (not suppressed, not baselined)
    and ``kernel_report`` is COOPT005's list of ``__global__`` functions
    with their page-table loads and guards.
    """
    files = collect_files(paths, root=root)
    by_path = {f.path: f for f in files}
    raw: List[Finding] = []
    kernel_report: List[Dict[str, object]] = []
    for mod in all_passes():
        if select and mod.CODE not in select:
            continue
        result = mod.run(files)
        if mod.CODE == "COOPT005":
            found, kernel_report = result
        else:
            found = result
        raw.extend(found)
    # dedupe (a pass may report the same node twice)
    raw = sorted(set(raw), key=lambda f: (f.path, f.line, f.code, f.message))
    suppressed, live = [], []
    for f in raw:
        ctx = by_path.get(f.path)
        if ctx is not None and ctx.suppressed(f.code, f.line):
            suppressed.append(f)
        else:
            live.append(f)
    baselined: List[Finding] = []
    if baseline_path:
        keys = baseline_keys(load_baseline(baseline_path))
        still_live = []
        for f in live:
            if f.match_key() in keys:
                baselined.append(f)
            else:
                still_live.append(f)
        live = still_live
    return live, suppressed, baselined, kernel_report
