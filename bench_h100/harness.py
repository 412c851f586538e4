"""One run of one cell: the engine built from the cell's configuration file,
the cell's traffic driven through ``AsyncEngine`` from client threads, a
measured window, the per-layer readers, and the comparison that decides
``correct``. ``run.py`` is the command; ``run_cell`` is also what the tests
drive on the CPU at a tiny size.

Threads: one serving loop (``AsyncEngine.run_until_idle``, again whenever
work arrives), the frontend's own emit worker, and the clients: 32 closed
clients, or one open-loop generator that submits on schedule and one
reader thread per open request. Every token's arrival is stamped by the
reader that takes it off its stream.
"""
from __future__ import annotations

import gc
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from bench_h100 import oracle, roofline, traffic
from bench_h100.record import Recorder, install
from bench_h100.window import ClientRecord, e2e, lateness

BENCH_DIR = Path(__file__).resolve().parent.name     # under the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SLICE_S = 10.0         # the traced slice of the window
PROFILER_START_S = 15.0      # CUPTI's start-up: 9.5-14.3 s on an H100 host
FOLLOW_S = 60.0              # how long a due request's first token is awaited
SAMPLE_EXTRA = 7             # requests compared besides the longest


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    """A metric with a ``workloads`` list is reported only in those
    cells."""
    return "workloads" not in metric or cell in metric["workloads"]


# ------------------------------------------------------------ the model --
MODEL_KEYS = (("num_hidden_layers", "num_layers"), ("hidden_size", "d_model"),
              ("num_attention_heads", "num_heads"),
              ("num_key_value_heads", "num_kv_heads"),
              ("intermediate_size", "d_ff"), ("vocab_size", "vocab_size"),
              ("rope_theta", "rope_theta"), ("rms_norm_eps", "norm_eps"),
              ("n_routed_experts", "num_experts"),
              ("n_shared_experts", "num_shared_experts"),
              ("num_experts_per_tok", "top_k"),
              ("moe_intermediate_size", "moe_d_ff"),
              ("first_k_dense_replace", "first_dense_layers"),
              ("kv_lora_rank", "kv_lora_rank"),
              ("qk_nope_head_dim", "qk_nope_head_dim"),
              ("qk_rope_head_dim", "qk_rope_head_dim"),
              ("v_head_dim", "v_head_dim"), ("qkv_bias", "qkv_bias"))


def check_model(cfg, hf: dict) -> None:
    """The program's model must have the configuration file's sizes."""
    bad = [f"{k}: file {hf[k]} program {getattr(cfg, a)}"
           for k, a in MODEL_KEYS
           if k in hf and hf[k] is not None and hf[k] != getattr(cfg, a)]
    D = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    if not hf.get("kv_lora_rank") and D != cfg.head_dim:
        bad.append(f"head_dim: file {D} program {cfg.head_dim}")
    if bad:
        raise ValueError(f"{hf['arch']} is not the configuration file's "
                         "model: " + "; ".join(bad))


# -------------------------------------------------------------- clients --
class Clients:
    """The cell's callers: closed-loop clients or an open-loop generator."""

    def __init__(self, ae, mix: dict, vocab: int, seed: int, rec: Recorder,
                 root: Path):
        self.ae, self.mix, self.rec = ae, mix, rec
        self.reqs = traffic.requests(mix, vocab, seed, root)
        self.records: List[ClientRecord] = []
        self.streams: Dict[int, object] = {}
        self.lock = threading.Lock()
        self.stop = threading.Event()       # no more submissions
        self.threads: List[threading.Thread] = []
        self.shift = 0.0        # the open loop's schedule, moved past pauses

    def _next(self, due: float) -> ClientRecord:
        with self.lock:
            r = next(self.reqs)
            cr = ClientRecord(idx=len(self.records), due=due,
                              max_new=r.max_new, prompt=r.prompt)
            self.records.append(cr)
        return cr

    def _submit(self, cr: ClientRecord):
        t0 = time.perf_counter()
        stream = self.ae.submit(cr.prompt, max_new_tokens=cr.max_new)
        t1 = time.perf_counter()
        cr.submit, cr.req_id = t0, stream.req.req_id
        if self.rec.detail:
            self.rec.span("submit", t0, t1)
        with self.lock:
            self.streams[cr.idx] = stream
        return stream

    @staticmethod
    def _read(cr: ClientRecord, stream) -> None:
        for tok in stream:
            cr.times.append(time.perf_counter())
            cr.tokens.append(tok)
        cr.finish = stream.finish_reason.name

    def _closed_client(self) -> None:
        while not self.stop.is_set():
            cr = self._next(time.perf_counter())
            self._read(cr, self._submit(cr))

    def _open_loop(self, w0: float, t_origin: float) -> None:
        """Submit on the schedule (``w0`` + each offset); an arrival due
        before the lead-in's start is skipped, its request with it."""
        for off in traffic.arrival_offsets(self.mix):
            if w0 + off < t_origin:
                next(self.reqs)
                continue
            while True:
                wait = w0 + off + self.shift - time.perf_counter()
                if wait <= 0:
                    break
                if self.stop.wait(min(wait, 0.05)):
                    return
            if self.stop.is_set():
                return
            cr = self._next(w0 + off + self.shift)
            stream = self._submit(cr)
            th = threading.Thread(target=self._read, args=(cr, stream),
                                  daemon=True)
            th.start()
            with self.lock:
                self.threads.append(th)

    def start(self, w0: float, t_origin: float) -> None:
        """Start the callers; the first thread started submits."""
        arr = self.mix["arrivals"]
        if arr["kind"] == "closed":
            targets = [(self._closed_client, ())] * int(arr["clients"])
        elif arr["kind"] == "poisson":
            targets = [(self._open_loop, (w0, t_origin))]
        else:
            raise ValueError(f"unknown arrivals {arr['kind']!r}")
        for fn, args in targets:
            th = threading.Thread(target=fn, args=args, daemon=True)
            th.start()
            self.threads.append(th)

    def open_streams(self) -> list:
        with self.lock:
            return [s for s in self.streams.values() if not s.closed]

    def cancel_and_join(self, timeout: float) -> bool:
        """Cancel every open request (again for one a client submitted as
        the window closed) until every client thread has ended."""
        end = time.perf_counter() + timeout
        while True:
            for s in self.open_streams():
                self.ae.cancel(s)
            with self.lock:
                alive = [t for t in self.threads if t.is_alive()]
            if not alive:
                return True
            if time.perf_counter() > end:
                return False
            alive[0].join(timeout=0.05)


class Loop:
    """The serving loop's thread: ``run_until_idle`` whenever work is
    waiting."""

    def __init__(self, ae):
        self.ae = ae
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        try:
            while not self.stop.is_set():
                self.ae.run_until_idle()
                self.stop.wait(0.0005)
        except BaseException as exc:          # reported by the run
            self.error = exc

    def start(self) -> None:
        self.thread.start()

    def close(self) -> None:
        self.stop.set()
        self.thread.join(timeout=30)


# ------------------------------------------------------------ the run --
@dataclass
class RunView:
    """What a per-layer reader reads (``metrics/<name>.py``): the host
    records over [w0, w1) (in a traced run, the window up to the slice's
    pause) with the engine's counters at both ends, and the tracer."""
    shapes: roofline.Shapes
    page_size: int
    rec: Recorder
    w0: float
    w1: float
    stats0: dict
    stats1: dict
    tracer: Optional[object] = None

    def window_steps(self):
        return [s for s in self.rec.steps if self.w0 <= s.t < self.w1]

    def slice_steps(self):
        tr = self.tracer
        if tr is None:
            return []
        return [s for s in self.rec.steps if tr.host0 <= s.t < tr.host1]

    def window_spans(self, name):
        return [(a, b) for n, a, b in self.rec.spans
                if n == name and self.w0 <= a < self.w1]


@dataclass
class Outcome:
    result: dict
    notes: List[str] = field(default_factory=list)     # stderr, earlier
    checks: List[str] = field(default_factory=list)    # stderr, last
    e2e: dict = field(default_factory=dict)
    readings: dict = field(default_factory=dict)


def _stats(engine) -> dict:
    s = engine.stats
    return {"hits": s.prefix_cache_hits, "queries": s.prefix_cache_queries}


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t_proc: float, device: str = "cuda",
             fault: Optional[Callable] = None, mix: Optional[dict] = None,
             check: bool = True, controls=()) -> Outcome:
    """One run; see the module doc. Not used by the command: ``fault``
    (tests) is called with the frontend before the traffic starts;
    ``mix`` replaces the mix file's (the knee sweep's rates);
    ``check=False`` skips the reference (the sweep); ``controls`` are further precisions of the reference read on
    the same sample (``control.py``), into ``Outcome.readings``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.coopt import MODES
    from repro_torch.launch.steps import serving_warmup
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.frontend import AsyncEngine

    from bench_h100.weights import make_params

    bench_dir = root / BENCH_DIR
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "config")
    hf = json.loads((root / conf["file"]).read_text())
    mix = mix or traffic.load_mix(cell["traffic"], bench_dir)
    out = Outcome(result={})
    cuda = device == "cuda"

    cfg = get_config(hf["arch"])
    check_model(cfg, hf)
    es = hf["engine"]
    coopt = MODES[es["mode"]].replace(use_kernel=es["use_kernel"],
                                      page_size=es["page_size"])
    if "moe_capacity_factor" in hf:
        coopt = coopt.replace(moe_capacity_factor=hf["moe_capacity_factor"])
    model = get_model(cfg)
    parts = {"imports_s": time.perf_counter() - t_proc}
    t = time.perf_counter()
    params = make_params(torch, model, seed, device)
    if cuda:
        torch.cuda.synchronize()
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ecfg = EngineConfig(num_lanes=es["num_lanes"], max_len=es["max_len"],
                        prefill_buckets=tuple(es["prefill_buckets"]),
                        token_budget=es["token_budget"],
                        pack_prefill=es["pack_prefill"], seed=seed % 2**31)
    engine = Engine(cfg, coopt, ecfg, params=params, device=device)
    ae = AsyncEngine(engine, pipeline_depth=es["pipeline_depth"],
                     warmup=False)
    parts["engine_s"] = time.perf_counter() - t
    warm = serving_warmup(engine)
    parts["warmup_s"] = warm["warmup_s"]

    rec = Recorder(detail=trace)
    tracer = None
    at_slice = {}
    if trace and cuda:
        from bench_h100.trace import Tracer

        def on_pause():
            at_slice.update(_stats(engine))

        def on_resume(dt):
            clients.shift += dt
        tracer = Tracer(torch, TRACE_SLICE_S, on_pause, on_resume)
    install(ae, rec, tracer.before_dispatch if tracer else None)
    if fault is not None:
        fault(ae)

    loop = Loop(ae)
    clients = Clients(ae, mix, cfg.vocab_size, seed, rec, bench_dir)
    loop.start()
    lead = mix["lead_in_s"]
    t_origin = time.perf_counter()
    w0 = t_origin + lead
    w1 = w0 + seconds
    if tracer is not None:
        # the slice, with the profiler's start-up pause before it, sits in
        # the window's middle
        tracer.t_start = w0 + max(
            (seconds - TRACE_SLICE_S - PROFILER_START_S) / 2, 0.0)
    clients.start(w0, t_origin)
    time.sleep(max(w0 - time.perf_counter(), 0.0))
    stats0 = _stats(engine)
    parts["lead_in_s"] = time.perf_counter() - t_origin
    setup_s = time.perf_counter() - t_proc
    if tracer is not None:
        tracer.serve(w1 + PROFILER_START_S)
        parts.update(tracer.times)
    time.sleep(max(w1 - time.perf_counter(), 0.0))
    stats1 = _stats(engine)
    clients.stop.set()
    if mix["arrivals"]["kind"] == "poisson":
        # the generator finishes a submission it began before the close
        clients.threads[0].join(timeout=30)
    # follow each request due in the window to its first token
    t_end = time.perf_counter() + FOLLOW_S
    while time.perf_counter() < t_end and loop.error is None and any(
            not r.times and r.finish is None
            for r in list(clients.records) if w0 <= r.due < w1):
        time.sleep(0.01)
    joined = clients.cancel_and_join(60.0)
    loop.close()
    ae.close()
    if loop.error is not None:
        raise RuntimeError("the serving loop failed") from loop.error
    if not joined:
        raise RuntimeError("client threads still open after cancelling")

    m = out.e2e = dict(e2e(clients.records, w0, w1), setup_s=setup_s)
    if mix["arrivals"]["kind"] == "poisson":
        lt = lateness(clients.records)
        out.notes.append("open-loop generator: submitted {submitted}, late "
                         "p50 {late_p50_ms:.3f} ms, max {late_max_ms:.3f} ms"
                         .format(**lt))
    out.notes.append(
        f"window {seconds} s: requests due {m['attempted']}, failed "
        f"{m['failed']}; with >= 2 tokens in the window "
        f"{m['tpot_requests']}; finished in the run "
        f"{sum(r.finish == 'FINISHED' for r in clients.records)}")
    out.notes.append("setup parts (s): " + json.dumps(
        {k: round(v, 3) for k, v in parts.items()}))
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # host metrics over the window up to the traced slice's pause, where
    # nothing of the profiler ran yet
    h1 = tracer.paused_at if tracer is not None else w1
    view = RunView(roofline.Shapes.of(hf), es["page_size"], rec, w0, h1,
                   stats0, at_slice or stats1, tracer)
    metrics: Dict[str, dict] = {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if not trace:
        for e in bench["end_to_end"]:
            if applies(e, workload) and m.get(e["name"]) is not None:
                metrics[e["name"]] = {"value": float(m[e["name"]]),
                                      "unit": e["unit"]}
    else:
        if tracer is not None:
            tracer.read()
            dev["busy_s"] = tracer.busy_s()
            dev["window_s"] = tracer.window_s
        for e in bench["per_layer"]:
            if not applies(e, workload):
                continue
            reader = traffic.load_file(
                bench_dir / "metrics" / f"{e['name']}.py",
                "_bench_metric_" + e["name"].replace(".", "_"))
            v = reader.read(view)
            if v is not None:
                metrics[e["name"]] = {"value": float(v), "unit": e["unit"]}

    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of the JAX stack or package are loaded: "
                         f"{found}")

    # ---- correctness, once the program's state is freed
    finished = [r for r in clients.records if r.finish == "FINISHED"]
    wrong = sum(len(r.tokens) != r.max_new for r in finished)
    rows = {r.req_id: oracle.rows_of(rec.layouts.get(r.req_id), r, es)
            for r in finished}
    chunks_wrong = sum(v is None for v in rows.values())
    sample = oracle.pick_sample(finished, seed, SAMPLE_EXTRA)
    del ae, engine, clients, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not check:
        out.result = {"metrics": metrics, "device": dev}
        return out
    t = time.perf_counter()
    ref = oracle.reference_module(hf["reference"], bench_dir)
    per = [oracle.served_gaps(torch, ref, params, hf, r, rows[r.req_id] or [],
                              device, controls) for r in sample]
    margins = [p["margin"] for p in per]
    rd = oracle.readings([p["gap"] for p in per], margins)
    out.readings = {"program": rd, "raw": per, "controls": [
        oracle.readings([p["controls"][i] for p in per], margins)
        for i in range(len(controls))]}
    out.notes.append(
        f"reference: {len(sample)} requests, {rd['served']} served tokens, "
        f"{time.perf_counter() - t:.1f} s; not the reference's first "
        f"{rd['not_first']}; widest gap {rd['logit_gap_max']}; contested "
        f"positions {rd['contested_positions']}, their mean gap "
        f"{rd['contested_gap_mean']}")
    limits = oracle.load_limits(workload, bench_dir)
    exact = {"tokens_wrong_count": float(wrong),
             "chunks_wrong_count": float(chunks_wrong)}
    verdict = oracle.check({name: exact[name] if name in exact
                            else rd.get(name)
                            for name in oracle.COMPARED}, limits)
    for name, c in verdict["checks"].items():
        out.checks.append(f"check {name}: {c['value']} (limit {c['limit']})")
    out.result = {"correct": verdict["correct"] and m["failed"] == 0,
                  "attempted": m["attempted"], "failed": m["failed"],
                  "metrics": metrics, "device": dev}
    if trace and tracer is not None:
        out.result["breakdown"] = tracer.breakdown(rec.spans)
    out.result["checks"] = verdict["checks"]
    return out
