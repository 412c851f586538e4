"""COOPT005 — the ``-1`` page sentinel in the CUDA kernels.

The paged kernels of ``kernels/csrc`` read the KV pool through page
tables whose ``-1`` entries mean "never allocated" (and the write kernel
through a slot table whose ``-1`` entries are the SkipSet). A kernel that
turns such an entry into an address without testing it first reads (or
writes) the line just before the pool: garbage in an attention sum, or a
write landing on a live line. So every load of a page address through a
table entry must be guarded against ``-1``, as ``flash_chunk_prefill.cu``
guards its stage (``if (phys[j] >= 0 ...) break; // never loaded``) and
``latent_chunk_prefill.cu`` its tiles.

The pass scans ``.cu``/``.cuh`` sources, comments stripped. For each
``__global__`` function it lists every read of a physical page or slot
table (``TABLES``, also as a field ``a.phys``) in its body, the lambdas
inside included, and how the read is guarded:
  * ``compared``: the read itself is compared with 0 or -1 (the guard);
  * ``via <var>``: the read is stored in a variable that the kernel
    compares with 0 or -1;
  * ``by line N``: the read feeds an address, and the kernel compares the
    same table's entries at line N (the walk reaches only live entries).
A read with none of these is a finding. The report (``kernel_report``,
``--format json``) lists every ``__global__`` function with its table
reads and guards, including kernels that read no table.

The pass is textual: a guard in a helper function outside the kernel's
body is not seen (allow such a read inline with ``// coopt:
allow[COOPT005]`` and the reason).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

from repro_torch.analysis.core import FileCtx, Finding

CODE = "COOPT005"

# physical page and slot tables: -1 = never allocated / SkipSet
TABLES = ("phys", "table_page", "visit_page", "page_table", "slots")

_GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
_READ_RE = re.compile(r"(?<![\w.])(?:\w+\.)?(" + "|".join(TABLES)
                      + r")\s*\[")
_CMP = r"\s*(?:>=|<=|<|>|==|!=)\s*-?[01]\b"


def _strip_comments(src: str) -> str:
    """``src`` with comments blanked, line breaks kept."""
    def blank(m):
        return re.sub(r"[^\n]", " ", m.group(0))
    return re.sub(r"//[^\n]*|/\*.*?\*/", blank, src, flags=re.S)


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def _subscript_end(text: str, i: int) -> int:
    return _match(text, text.index("[", i), "[", "]")


def kernels(text: str) -> List[Tuple[str, int, int]]:
    """(name, body start, body end) of each ``__global__`` function of a
    comment-stripped source."""
    out = []
    for m in _GLOBAL_RE.finditer(text):
        params_end = _match(text, m.end() - 1, "(", ")")
        body = text.index("{", params_end)
        out.append((m.group(1), body, _match(text, body, "{", "}")))
    return out


def _line(text: str, i: int) -> int:
    return text.count("\n", 0, i) + 1


def _scan_kernel(text: str, lo: int, hi: int) -> List[Dict[str, object]]:
    body = text[lo:hi]
    reads = []
    for m in _READ_RE.finditer(body):
        end = _subscript_end(body, m.start())
        reads.append((m.group(1), m.start(), end))
    guards: Dict[str, int] = {}          # table -> first compared read
    for table, s, e in reads:
        if re.match(_CMP, body[e:]):
            guards.setdefault(table, _line(text, lo + s))
    out = []
    for table, s, e in reads:
        line = _line(text, lo + s)
        if re.match(_CMP, body[e:]):
            guard = "compared"
        else:
            guard = ""
            start = body.rfind("\n", 0, s) + 1
            m = re.search(r"(\w+)\s*=[^=][^;]*$", body[start:s])
            var = m.group(1) if m else None
            if var and re.search(rf"(?<![\w.]){var}{_CMP}", body):
                guard = f"via {var}"
            elif table in guards:
                guard = f"by line {guards[table]}"
        out.append({"line": line, "table": table,
                    "read": body[s:e].strip(), "guard": guard})
    return out


def run(files: List[FileCtx]):
    findings: List[Finding] = []
    report: List[Dict[str, object]] = []
    for f in files:
        if not f.path.endswith((".cu", ".cuh")):
            continue
        text = _strip_comments(f.source)
        for name, lo, hi in kernels(text):
            reads = _scan_kernel(text, lo, hi)
            report.append({"kernel": name, "path": f.path,
                           "line": _line(text, lo), "table_loads": reads,
                           "unguarded": sum(not r["guard"] for r in reads)})
            for r in reads:
                if r["guard"]:
                    continue
                findings.append(Finding(
                    code=CODE, path=f.path, line=r["line"], symbol=name,
                    message=(f"page-table load {r['read']} with no -1 "
                             f"guard in kernel {name}: a never-allocated "
                             "entry would address the line before the "
                             "pool; test the entry (>= 0) before using "
                             "it")))
    return findings, report
