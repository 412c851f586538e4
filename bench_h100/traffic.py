"""The one general traffic generator: a cell's mix file (``traffic/<mix>.json``)
and ``--seed`` give the requests and their arrivals.

A mix file holds two parts:
  * ``requests``: ``kind`` names the generator module ``generators/<kind>.py``
    (found by that name); the rest are its parameters.
  * ``arrivals``: ``poisson`` (an open loop at ``rate_per_s``) or ``closed``
    (``clients`` callers, each sending its next request when its last one
    ended).

Every seed gets the same work: the seed draws the token ids and nothing
else. Sizes and gaps are the midpoint quantiles of their distributions
over a block of ``block`` requests, so each block holds the same multiset
of sizes and spans the same seconds; with ``strata`` m, each run of m
requests holds one size (and one gap) of each of m strata. The blocks'
orders are drawn once from a fixed generator, the same for every seed, so
a window's sizes and arrivals do not move with the seed (an order drawn
from the seed moved a window's tail latencies by 20-36%). An open loop's
schedule puts the second block's first arrival at the window's opening,
so a window of ``block / rate_per_s`` seconds holds exactly one block.
"""
from __future__ import annotations

import importlib.util
import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Iterator

import numpy as np

HERE = Path(__file__).resolve().parent


@dataclass(frozen=True)
class ShareGPTStats:
    """Lognormal length model of the ShareGPT conversation mix, a frozen
    copy of ``src/repro_torch/data/pipeline.py:24-35`` (``ShareGPTStats``)."""
    prompt_log_mean: float = 5.1      # exp(5.1) ~ 164 tokens median
    prompt_log_std: float = 0.9
    output_log_mean: float = 5.5      # exp(5.5) ~ 245 tokens median
    output_log_std: float = 0.8
    min_prompt: int = 4
    max_prompt: int = 2048
    min_output: int = 4
    max_output: int = 1024


@dataclass
class Req:
    """One generated request: its prompt ids and output length."""
    prompt: np.ndarray
    max_new: int


def lognormal_quantiles(k: int, mu: float, sigma: float, lo: int,
                        hi: int) -> list:
    """The ``k`` midpoint quantiles of lognormal(mu, sigma), as token
    counts clipped to [lo, hi] (``RequestStream._len``'s rounding)."""
    nd = NormalDist()
    return [int(np.clip(int(math.exp(mu + sigma * nd.inv_cdf((i + .5) / k))),
                        lo, hi)) for i in range(k)]


def exponential_quantiles(k: int, mean: float) -> list:
    return [-mean * math.log(1 - (i + .5) / k) for i in range(k)]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the seed (``stream`` keeps the
    token ids, the order and the arrivals apart)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def stratified(order: np.random.Generator, k: int, m: int) -> np.ndarray:
    """A permutation of the ``k`` sorted quantiles in which each run of
    ``m`` places holds one quantile of each of ``m`` strata (consecutive
    quantiles), so the largest sizes (or gaps) are spread over the block
    and never bunch up."""
    if m <= 1 or k % m:
        return order.permutation(k)
    strata = np.arange(k).reshape(m, k // m)          # m strata, k/m each
    picks = np.stack([order.permutation(row) for row in strata])  # (m, k/m)
    runs = [order.permutation(picks[:, j]) for j in range(k // m)]
    return np.concatenate(runs)


def block_orders(stream: int) -> Iterator[np.random.Generator]:
    """The generator that orders each block, the same for every seed."""
    order = rng_for(0, 100 + stream)
    while True:
        yield order


def load_mix(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def load_file(path: Path, name: str):
    """A module from a file of the benchmark, found by its name (a
    generator, a reference, a per-layer metric)."""
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def requests(mix: dict, vocab: int, seed: int,
             root: Path = HERE) -> Iterator[Req]:
    """The mix's endless request sequence for ``seed``."""
    spec = mix["requests"]
    gen = load_file(root / "generators" / f"{spec['kind']}.py",
                    f"_bench_gen_{spec['kind']}")
    return gen.requests(
        spec, vocab, rng_for(seed, 1), block_orders(1))


def arrival_offsets(mix: dict) -> Iterator[float]:
    """An open loop's due times, in seconds from the window's opening:
    exponential gaps at ``rate_per_s``, the block's midpoint quantiles
    scaled to span exactly ``block / rate_per_s``, each block in its
    order (the same for every seed). Block b starts at exactly
    (b - 1) * span, so the first block ends as the window opens and the
    arrival at the window's close belongs to the next window."""
    arr = mix["arrivals"]
    if arr["kind"] != "poisson":
        raise ValueError(f"{arr['kind']!r} has no schedule")
    k = int(mix["requests"].get("block", 32))
    span = k / float(arr["rate_per_s"])
    gaps = exponential_quantiles(k, 1.0)
    gaps = [g * span / sum(gaps) for g in gaps]
    m = int(mix["requests"].get("strata", 1))
    for b, order in enumerate(block_orders(2)):
        t = (b - 1) * span
        for i in stratified(order, k, m):
            yield t
            t += gaps[i]
