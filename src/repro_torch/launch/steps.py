"""Launch-time steps of the port. Only ``serving_warmup`` is ported so far:
the rest of the JAX package's ``launch/steps.py`` (the dry-run step
bundles) waits for ROADMAP item 17."""
from __future__ import annotations

import time
from typing import Any, Dict


def serving_warmup(engine) -> Dict[str, Any]:
    """Build the serving engine's step runner for every shape of the bucket
    lattice at launch time (``Engine.warmup``: decode, prefill buckets and,
    packing, row buckets x prefill buckets; on CUDA each runner captures a
    CUDA graph), and return a summary for the launch report: the JAX
    package's keys (``aot_executables``: runners built, ``aot_by_kind``,
    ``warmup_s``) and ``graph_pool_gib``, the memory the captures reserved
    (the port's counterpart of what AOT compilation costs). After this,
    steady-state serving builds no runner (``engine.aot_misses`` stays 0)."""
    t0 = time.perf_counter()
    built = engine.warmup()
    kinds: Dict[str, int] = {}
    for key in engine._runners:
        kinds[key[0]] = kinds.get(key[0], 0) + 1
    return {"aot_executables": built,
            "aot_by_kind": kinds,
            "warmup_s": round(time.perf_counter() - t0, 3),
            "graph_pool_gib": round(engine.graph_pool_bytes / 2**30, 4)}
