"""ShareGPT-like chat requests: lognormal prompt and output lengths (the
frozen ``traffic.ShareGPTStats``), unshared random prompts, EOS ignored so
each request produces its drawn output length."""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from bench_h100.traffic import (Req, lognormal_quantiles,  # noqa: E402
                                stratified)


def requests(spec: dict, vocab: int, rng, orders):
    """``rng`` draws the token ids; ``orders`` gives each block's order."""
    k = int(spec["block"])
    plens = lognormal_quantiles(k, spec["prompt_log_mean"],
                                spec["prompt_log_std"], spec["min_prompt"],
                                spec["max_prompt"])
    olens = lognormal_quantiles(k, spec["output_log_mean"],
                                spec["output_log_std"], spec["min_output"],
                                spec["max_output"])
    m = int(spec.get("strata", 1))
    for order in orders:
        for i, j in zip(stratified(order, k, m), stratified(order, k, m)):
            yield Req(rng.integers(0, vocab, plens[i], dtype="int32"),
                      olens[j])
