"""The end-to-end metrics of a window, from the clients' own records: when
each request was due, and when each of its tokens reached the client."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class ClientRecord:
    """One request as its client saw it (host clock, seconds)."""
    idx: int                    # place in the traffic sequence
    due: float                  # when the request was due
    max_new: int
    prompt: np.ndarray
    submit: float = -1.0        # when the client submitted it
    times: List[float] = field(default_factory=list)    # token arrivals
    tokens: List[int] = field(default_factory=list)
    req_id: int = -1
    finish: Optional[str] = None    # FinishReason name once the stream closed


def percentile(xs, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs, float), q)) if len(xs) else None


def due_in(records, w0: float, w1: float) -> list:
    return [r for r in records if w0 <= r.due < w1]


def e2e(records, w0: float, w1: float) -> dict:
    """``output_tok_s``: tokens delivered inside [w0, w1) over its seconds.
    ``ttft_p90_ms``: p90 of first-token time from the due time over the
    requests due inside the window that got a token. ``tpot_p90_ms``: p90
    over requests with two or more tokens inside the window of their mean
    gap between those tokens. Returns the metrics and the counts."""
    due = due_in(records, w0, w1)
    ttft = [r.times[0] - r.due for r in due if r.times]
    tpot, n_tok = [], 0
    for r in records:
        ts = [t for t in r.times if w0 <= t < w1]
        n_tok += len(ts)
        if len(ts) >= 2:
            tpot.append((ts[-1] - ts[0]) / (len(ts) - 1))
    p_ttft, p_tpot = percentile(ttft, 90), percentile(tpot, 90)
    return {"output_tok_s": n_tok / (w1 - w0),
            "ttft_p90_ms": None if p_ttft is None else p_ttft * 1e3,
            "tpot_p90_ms": None if p_tpot is None else p_tpot * 1e3,
            "attempted": len(due),
            "failed": sum(1 for r in due if not r.times),
            "tpot_requests": len(tpot)}


def lateness(records) -> dict:
    """How late the open-loop generator submitted against its schedule."""
    late = [r.submit - r.due for r in records if r.submit >= 0]
    return {"late_p50_ms": (percentile(late, 50) or 0.0) * 1e3,
            "late_max_ms": max(late, default=0.0) * 1e3,
            "submitted": len(late)}
