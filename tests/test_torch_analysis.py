"""The port's cooptlint (``repro_torch.analysis``): the twins of
``tests/test_analysis.py``'s cases that have a torch meaning, one good and
one bad fixture per finding code (COOPT001 host syncs, COOPT003 mesh-ctx
scoping, COOPT004 CUDA-graph capture safety, COOPT005 the CUDA kernels'
-1 page guard, COOPT006 fault swallowing), inline suppression, the
baseline round trip with line drift, and the gate: ``python -m
repro_torch.analysis src/repro_torch`` exits 0 on the committed tree and
its kernel report covers every ``__global__`` function of ``csrc``."""
import json
import os
import re
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import run_suite, write_baseline

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO_ROOT, "src", "repro_torch", "kernels", "csrc")


def _lint(tmp_path, relpath, source, **kw):
    p = tmp_path / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return run_suite([str(tmp_path)], root=str(tmp_path), **kw)


def _codes(findings):
    return [f.code for f in findings]


# ------------------------------------------------------------- COOPT001 --
BAD_SYNC = """
    import torch

    class Engine:
        def _build_step(self, toks):
            return toks.item()          # stray sync on the plan path
"""

GOOD_SYNC = """
    import torch

    class Engine:
        def _execute(self, sb):
            torch.cuda.synchronize()    # the designated host boundary
            return sb.toks.cpu().numpy()

        def _build_step(self, plan):
            return int(len(plan)) + int(3)   # host values only
"""


def test_host_sync_bad(tmp_path):
    live, *_ = _lint(tmp_path, "serving/engine.py", BAD_SYNC)
    assert _codes(live) == ["COOPT001"]
    assert live[0].symbol == "Engine._build_step"


def test_host_sync_good(tmp_path):
    live, *_ = _lint(tmp_path, "serving/engine.py", GOOD_SYNC)
    assert live == []


@pytest.mark.parametrize("sync", [
    "torch.cuda.synchronize()", "self.event.synchronize()",
    "toks.tolist()", "toks.cpu()", "toks.numpy()", "float(toks)",
    "int(toks[0])", "np.asarray(toks)"])
def test_host_sync_patterns(tmp_path, sync):
    """Each of the port's sync patterns, outside a designated scope."""
    src = BAD_SYNC.replace("toks.item()", sync)
    live, *_ = _lint(tmp_path, "serving/frontend.py", src)
    assert _codes(live) == ["COOPT001"], sync


def test_host_sync_only_serving_modules(tmp_path):
    # the same sync outside serving/ is not this pass's business
    live, *_ = _lint(tmp_path, "models/util.py", BAD_SYNC)
    assert live == []


# ------------------------------------------------------------- COOPT003 --
BAD_MESH = """
    from repro_torch.kernels import ops

    def run_step(ctx, fn, x):
        ops.set_mesh_ctx(ctx)           # never restored
        return fn(x)
"""

GOOD_MESH = """
    from repro_torch.kernels import ops

    def run_step(ctx, fn, x):
        with ops.mesh_ctx_scope(ctx):
            return fn(x)

    def run_step_paired(ctx, fn, x):
        saved = ops.mesh_ctx()
        ops.set_mesh_ctx(ctx)
        try:
            return fn(x)
        finally:
            ops.set_mesh_ctx(saved)
"""


def test_mesh_ctx_bad(tmp_path):
    live, *_ = _lint(tmp_path, "launch/x.py", BAD_MESH)
    assert _codes(live) == ["COOPT003"]


def test_mesh_ctx_module_level_install(tmp_path):
    src = """
    from repro_torch.kernels import ops
    ops.set_mesh_ctx(None)
    """
    live, *_ = _lint(tmp_path, "launch/x.py", src)
    assert _codes(live) == ["COOPT003"] and live[0].symbol == ""


def test_mesh_ctx_good(tmp_path):
    live, *_ = _lint(tmp_path, "launch/x.py", GOOD_MESH)
    assert live == []


# ------------------------------------------------------------- COOPT004 --
BAD_CAPTURE_GLOBAL = """
    import torch

    SCALE = 1.0

    def configure(s):
        global SCALE
        SCALE = s

    def body(x):
        return x * SCALE                # baked into every replay

    def capture(g, x):
        with torch.cuda.graph(g):
            return body(x)
"""

GOOD_CAPTURE_GLOBAL = """
    import torch

    SCALE = 1.0

    def configure(s):
        global SCALE
        SCALE = s

    def body(x, scale):
        return x * scale

    def capture(g, x, scale):
        with torch.cuda.graph(g):
            return body(x, scale)      # an input of the capture
"""


def test_capture_global_bad(tmp_path):
    live, *_ = _lint(tmp_path, "serving/x.py", BAD_CAPTURE_GLOBAL)
    assert _codes(live) == ["COOPT004"]
    assert "SCALE" in live[0].message and live[0].symbol == "body"


def test_capture_global_good(tmp_path):
    live, *_ = _lint(tmp_path, "serving/x.py", GOOD_CAPTURE_GLOBAL)
    assert live == []


CAPTURE_SELF = """
    import torch

    class Runner:
        def __init__(self, buf):
            self.buf = buf
            self.table = None

        def place(self, t):
            self.table = t               # stored outside __init__

        def body(self):
            return self._inner() + self.buf

        def _inner(self):
            return self.table * 2        # reached from the body

        def capture(self, g):
            with torch.cuda.graph(g):
                self.out = self.body()
"""


def test_capture_mutable_self_attr(tmp_path):
    """A method the captured body calls through ``self`` reads an
    attribute stored outside ``__init__``; ``self.buf`` (stored in
    ``__init__`` only) is fine."""
    live, *_ = _lint(tmp_path, "serving/x.py", CAPTURE_SELF)
    assert _codes(live) == ["COOPT004"]
    assert "self.table" in live[0].message
    assert live[0].symbol == "Runner._inner"


def test_capture_registry_names_the_engine_step(tmp_path):
    """``Engine._async_step`` is captured through its runner (the pass's
    ``CAPTURED``): its reads are checked without a ``with`` block."""
    src = """
    class Engine:
        def __init__(self):
            self.lane_tok = None

        def reset(self):
            self.lane_tok = 0

        def _async_step(self, kind, inp):
            return inp + self.lane_tok
    """
    live, *_ = _lint(tmp_path, "serving/engine.py", src)
    assert _codes(live) == ["COOPT004"]
    good = src.replace("self.lane_tok = 0", "self.other = 0")
    live, *_ = _lint(tmp_path / "g", "serving/engine.py", good)
    assert live == []


# ------------------------------------------------------------- COOPT005 --
KERNEL = """
    #include <cuda_runtime.h>
    // a kernel walking a page table
    template <int D>
    __global__ void __launch_bounds__(128) walk_kernel(const int* phys,
                                                        const float* pages,
                                                        float* out, int np) {
      for (int j = 0; j < np; ++j) {
        {GUARD}
        out[j] = pages[(long long)phys[j] * D];
      }
    }
    __global__ void plain_kernel(float* out) { out[threadIdx.x] = 0.f; }
"""


def _kernel(guard):
    return KERNEL.replace("{GUARD}", guard)


def test_page_guard_compared_ok(tmp_path):
    live, _s, _b, report = _lint(tmp_path, "kernels/csrc/k.cu",
                                 _kernel("if (phys[j] < 0) continue;"))
    assert live == []
    names = {e["kernel"]: e for e in report}
    assert set(names) == {"walk_kernel", "plain_kernel"}
    assert [r["guard"] for r in names["walk_kernel"]["table_loads"]] == \
        ["compared", "by line 9"]
    assert names["plain_kernel"]["table_loads"] == []


def test_page_guard_via_variable_ok(tmp_path):
    src = _kernel("").replace(
        "out[j] = pages[(long long)phys[j] * D];",
        "const int page = phys[j];\n"
        "        if (page >= 0) out[j] = pages[(long long)page * D];")
    live, _s, _b, report = _lint(tmp_path, "kernels/csrc/k.cu", src)
    assert live == []
    assert report[0]["table_loads"][0]["guard"] == "via page"


def test_page_guard_unguarded_flagged(tmp_path):
    live, _s, _b, report = _lint(tmp_path, "kernels/csrc/k.cu", _kernel(""))
    assert _codes(live) == ["COOPT005"]
    assert live[0].symbol == "walk_kernel" and "-1" in live[0].message
    assert report[0]["unguarded"] == 1


def test_page_guard_comment_is_not_a_guard(tmp_path):
    # a guard that lives only in a comment guards nothing
    live, *_ = _lint(tmp_path, "kernels/csrc/k.cu",
                     _kernel("// if (phys[j] < 0) continue;"))
    assert _codes(live) == ["COOPT005"]


def test_page_guard_inline_suppression(tmp_path):
    src = _kernel("").replace(
        "out[j] = pages[",
        "// coopt: allow[COOPT005] the caller passes no -1 entry\n"
        "        out[j] = pages[")
    live, suppressed, *_ = _lint(tmp_path, "kernels/csrc/k.cu", src)
    assert live == [] and _codes(suppressed) == ["COOPT005"]


# ------------------------------------------------------------- COOPT006 --
BAD_EXCEPT = """
    class Worker:
        def run(self):
            while True:
                try:
                    self.step()
                except Exception:
                    pass                    # fault swallowed
"""

GOOD_EXCEPT = """
    class Worker:
        def run(self):
            try:
                self.step()
            except Exception as exc:
                self.post(exc)              # recorded, not swallowed
            try:
                self.step()
            except ValueError:
                pass                        # narrow handlers are policy
            try:
                self.step()
            except Exception:
                self.note()
                raise                       # re-raised
"""


def test_exceptions_bad(tmp_path):
    live, *_ = _lint(tmp_path, "serving/worker.py", BAD_EXCEPT)
    assert _codes(live) == ["COOPT006"]
    assert live[0].symbol == "Worker.run"


def test_exceptions_good(tmp_path):
    live, *_ = _lint(tmp_path, "serving/worker.py", GOOD_EXCEPT)
    assert live == []


def test_exceptions_bound_but_unused(tmp_path):
    src = BAD_EXCEPT.replace("except Exception:",
                             "except Exception as exc:")
    live, *_ = _lint(tmp_path, "serving/worker.py", src)
    assert _codes(live) == ["COOPT006"]


def test_exceptions_bare_except(tmp_path):
    src = BAD_EXCEPT.replace("except Exception:", "except:")
    live, *_ = _lint(tmp_path, "serving/worker.py", src)
    assert _codes(live) == ["COOPT006"]
    assert "bare except" in live[0].message


def test_exceptions_only_serving_modules(tmp_path):
    live, *_ = _lint(tmp_path, "launch/run.py", BAD_EXCEPT)
    assert live == []


# --------------------------------------------- suppression and baseline --
def test_inline_suppression(tmp_path):
    src = BAD_SYNC.replace(
        "return toks.item()          # stray sync on the plan path",
        "return toks.item()  # coopt: allow[COOPT001]")
    live, suppressed, *_ = _lint(tmp_path, "serving/engine.py", src)
    assert live == [] and _codes(suppressed) == ["COOPT001"]


def test_inline_suppression_line_above(tmp_path):
    src = BAD_SYNC.replace(
        "return toks.item()          # stray sync on the plan path",
        "# coopt: allow[COOPT001]\n            return toks.item()")
    live, suppressed, *_ = _lint(tmp_path, "serving/engine.py", src)
    assert live == [] and _codes(suppressed) == ["COOPT001"]


def test_inline_suppression_wrong_code_does_not_apply(tmp_path):
    src = BAD_SYNC.replace(
        "return toks.item()          # stray sync on the plan path",
        "return toks.item()  # coopt: allow[COOPT005]")
    live, suppressed, *_ = _lint(tmp_path, "serving/engine.py", src)
    assert _codes(live) == ["COOPT001"] and suppressed == []


def test_baseline_round_trip(tmp_path):
    p = tmp_path / "serving" / "engine.py"
    p.parent.mkdir(parents=True)
    p.write_text(textwrap.dedent(BAD_SYNC))
    live, _s, _b, _r = run_suite([str(tmp_path)], root=str(tmp_path))
    assert _codes(live) == ["COOPT001"]

    bl = tmp_path / "baseline.json"
    write_baseline(str(bl), live)
    data = json.loads(bl.read_text())
    assert len(data["findings"]) == 1
    assert "justification" in data["findings"][0]

    live2, _s, baselined2, _r = run_suite(
        [str(tmp_path)], root=str(tmp_path), baseline_path=str(bl))
    assert live2 == [] and _codes(baselined2) == ["COOPT001"]

    # baseline matching ignores line drift: shift the file down two lines
    p.write_text("# pad\n# pad\n" + textwrap.dedent(BAD_SYNC))
    live3, _s, baselined3, _r = run_suite(
        [str(tmp_path)], root=str(tmp_path), baseline_path=str(bl))
    assert live3 == [] and _codes(baselined3) == ["COOPT001"]


# ----------------------------------------------------------- repo gate --
def test_repo_is_clean():
    """The committed port passes its own linter (the CI gate), its
    baseline entries each carry a justification, and the kernel report
    names every ``__global__`` function of ``kernels/csrc``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "--format", "json"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True)
    payload = json.loads(res.stdout)
    assert res.returncode == 0, payload["findings"]
    assert payload["findings"] == []
    with open(os.path.join(REPO_ROOT, "src", "repro_torch", "analysis",
                           "baseline.json")) as f:
        for e in json.load(f)["findings"]:
            assert e["justification"] and "TODO" not in e["justification"]
    want = set()
    for fn in os.listdir(CSRC):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn)) as f:
                want |= {(fn, m) for m in re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                    r"\s*)?(\w+)", f.read())}
    got = {(os.path.basename(e["path"]), e["kernel"])
           for e in payload["kernel_report"]}
    assert want and got == want
    assert all(e["unguarded"] == 0 for e in payload["kernel_report"])
    # the paged kernels each read a table, every read guarded
    reads = {e["kernel"]: e["table_loads"] for e in payload["kernel_report"]}
    for k in ("chunk_kernel", "decode_kernel", "latent_chunk_kernel",
              "latent_decode_kernel", "kv_write_kernel"):
        assert reads[k] and all(r["guard"] for r in reads[k]), k
