"""Data pipelines of the port: a numpy-only copy of the JAX package's
``data/pipeline.py``, so the same seed and scale give the same requests.

Serving: synthetic request streams with the length statistics of
ShareGPT_V3_unfiltered_cleaned_split (the paper's throughput dataset §4.2).
No dataset ships with the container, so lengths are drawn from lognormal fits
of the published ShareGPT distribution (prompt median ~ 160 tok, long tail to
2k+; output median ~ 240 tok) — what matters for the paper's claims is the
*length mix* (page occupancy, padding fraction, batch churn), not the text.

Training: deterministic synthetic LM batches (token stream + shifted labels)
for the train_4k shape and the end-to-end training example.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclass(frozen=True)
class ShareGPTStats:
    """Lognormal length model of the ShareGPT conversation mix."""
    prompt_log_mean: float = 5.1      # exp(5.1) ~ 164 tokens median
    prompt_log_std: float = 0.9
    output_log_mean: float = 5.5      # exp(5.5) ~ 245 tokens median
    output_log_std: float = 0.8
    min_prompt: int = 4
    max_prompt: int = 2048
    min_output: int = 4
    max_output: int = 1024


class RequestStream:
    """Deterministic synthetic ShareGPT-like request source."""

    def __init__(self, vocab_size: int, stats: ShareGPTStats = ShareGPTStats(),
                 seed: int = 0, scale: float = 1.0):
        """``scale`` shrinks lengths (reduced-model benchmarks on CPU)."""
        self.vocab = vocab_size
        self.stats = stats
        self.rng = np.random.default_rng(seed)
        self.scale = scale
        self._next_id = 0

    def _len(self, mu, sigma, lo, hi) -> int:
        n = int(np.exp(self.rng.normal(mu, sigma)) * self.scale)
        return int(np.clip(n, max(int(lo * self.scale), 2),
                           max(int(hi * self.scale), 4)))

    def next_request(self, max_new_tokens: Optional[int] = None) -> Request:
        st = self.stats
        plen = self._len(st.prompt_log_mean, st.prompt_log_std,
                         st.min_prompt, st.max_prompt)
        olen = max_new_tokens or self._len(st.output_log_mean,
                                           st.output_log_std,
                                           st.min_output, st.max_output)
        prompt = self.rng.integers(0, self.vocab, plen, dtype=np.int32)
        self._next_id += 1
        return Request(req_id=self._next_id, prompt=prompt,
                       max_new_tokens=olen)

    def take(self, n: int, max_new_tokens: Optional[int] = None
             ) -> List[Request]:
        return [self.next_request(max_new_tokens) for _ in range(n)]


def sharegpt_stream(vocab_size: int, n: int, seed: int = 0,
                    scale: float = 1.0) -> List[Request]:
    return RequestStream(vocab_size, seed=seed, scale=scale).take(n)


# ---------------------------------------------------------------- training --
class TrainPipeline:
    """Synthetic LM batches: structured (Zipf-ish) token stream so the loss
    actually decreases during the end-to-end training example."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        # fixed bigram table => learnable structure
        self._succ = self.rng.integers(0, vocab_size,
                                       (vocab_size, 4), dtype=np.int32)

    def next_batch(self) -> dict:
        B, S = self.batch, self.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = self.rng.integers(0, self.vocab, B)
        noise = self.rng.random((B, S))
        choice = self.rng.integers(0, 4, (B, S))
        rand_tok = self.rng.integers(0, self.vocab, (B, S), dtype=np.int32)
        for t in range(S):
            follow = self._succ[toks[:, t], choice[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.85, follow,
                                      rand_tok[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def train_batches(vocab_size: int, batch: int, seq_len: int, steps: int,
                  seed: int = 0) -> Iterator[dict]:
    pipe = TrainPipeline(vocab_size, batch, seq_len, seed)
    for _ in range(steps):
        yield pipe.next_batch()
