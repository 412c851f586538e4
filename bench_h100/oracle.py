"""How ``correct`` is decided for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests that finished, drawn from the seed with the longest among
them, is run through the plain reference (``reference/<name>.py``) over
each prompt followed by its served tokens. For each served token the gap
is the reference's best logit less the reference's logit of the served
token (0 where they agree). The number compared is the mean squared gap
over the contested positions (``readings``).

The control (``control.py``, not part of a run) puts the reference computed
in FP8 in the program's place: at each position of the same sequences, the
gap of the token that the FP8 reference puts first.

Two numbers are exact (limit 0): every finished request delivered exactly
the tokens it asked for, and every finished request's prompt chunks, as
the scheduler planned them, cover its sequence once, in order, within the
configured token budget (``rows_of``)."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from bench_h100.traffic import load_file, rng_for

HERE = Path(__file__).resolve().parent
# logits: the band of the reference's margin (best less second best) in
# which a served token's gap is compared. Below 0.05 two logits tie at the
# program's bf16 logit rounding (one ulp at 4-8 is 0.031), and both
# precisions pick either; from 0.25 up neither moves.
CONTESTED = (0.05, 0.25)
# the numbers ``correct`` compares, each against limits/<cell>.json
COMPARED = ("contested_gap_ms", "tokens_wrong_count", "chunks_wrong_count")


def reference_module(name: str, root: Path = HERE):
    return load_file(root / "reference" / f"{name}.py", f"_bench_ref_{name}")


def pick_sample(finished, seed: int, extra: int) -> list:
    """The finished request with the most served tokens, and ``extra``
    more drawn from the seed."""
    if not finished:
        return []
    finished = sorted(finished, key=lambda r: r.idx)
    longest = max(finished, key=lambda r: (len(r.tokens), -r.idx))
    rest = [r for r in finished if r is not longest]
    pick = rng_for(seed, 3).permutation(len(rest))[:extra]
    return [longest] + [rest[i] for i in sorted(pick)]


def bucket(n: int, buckets) -> int:
    """The row width of a step whose longest chunk has ``n`` tokens: the
    smallest configured prefill bucket holding it, else ``n``."""
    return next((b for b in sorted(buckets) if n <= b), n)


def rows_of(layout, r, engine: dict):
    """The MoE rows (start, n, S) of request ``r``'s prompt chunks, worked
    out from the configuration: ``layout`` holds each planned chunk as
    (start, n, the longest chunk of its step), and S is that step's bucket.
    Only the last admission counts: a chunk that starts at or before the
    one before it begins a recompute (after a preemption), which replaces
    what came before. None where the chunks do not cover the sequence from
    0 once and in order (to the prompt's end at least, short of the last
    served token), or a chunk is empty or over the token budget."""
    chunks = []
    for c in layout or []:
        if chunks and c[0] <= chunks[-1][0]:
            chunks = []
        chunks.append(c)
    end, budget = 0, engine["token_budget"]
    for start, n, longest in chunks:
        if start != end or not 1 <= n <= longest <= budget:
            return None
        end = start + n
    if not len(r.prompt) <= end < len(r.prompt) + max(len(r.tokens), 1):
        return None
    return [(start, n, bucket(longest, engine["prefill_buckets"]))
            for start, n, longest in chunks]


def sequence(torch, r, device):
    """(tokens, positions predicting each served token)."""
    seq = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
    P = len(r.prompt)
    tokens = torch.as_tensor(seq, dtype=torch.long, device=device)
    want = torch.arange(P - 1, P - 1 + len(r.tokens), device=device)
    return tokens, want


def served_gaps(torch, ref, params, hf, r, groups, device, precs) -> dict:
    """For request ``r``: ``gap``, the f32 reference's gap of each served
    token; ``margin``, the reference's best logit less its second best at
    each of those positions; ``controls``, for each precision in ``precs``
    the f32 gap of the token that precision puts first. ``groups``: the
    MoE rows (``rows_of``)."""
    from bench_h100.reference.common import F32, exact_f32
    tokens, want = sequence(torch, r, device)
    served = torch.as_tensor(r.tokens, dtype=torch.long, device=device)
    with exact_f32(), torch.no_grad():
        ref_l = ref.logits(params, hf, tokens, want, groups, F32())
        top2 = ref_l.topk(2, dim=-1).values
        best = top2[:, 0]

        def gap(tok):
            return (best - ref_l.gather(1, tok[:, None])[:, 0]).cpu().numpy()
        out = {"gap": gap(served),
               "margin": (top2[:, 0] - top2[:, 1]).cpu().numpy(),
               "controls": []}
        for prec in precs:
            out["controls"].append(gap(ref.logits(
                params, hf, tokens, want, groups, prec).argmax(dim=-1)))
    return out


def readings(gaps, margins) -> dict:
    """The numbers a sample gives. Over the positions whose reference
    margin lies in the ``CONTESTED`` band (where a precision's error picks
    another token; positions deep in a greedy loop mostly fall outside):
    ``contested_gap_ms``, the mean squared gap (the number compared: an
    error of size e picks another token there with a chance that grows
    with e, by a gap that grows with e), and ``contested_gap_mean``; over
    all served tokens, ``logit_gap_max``, the widest gap."""
    g = np.concatenate(gaps) if gaps else np.zeros(0)
    m = np.concatenate(margins) if margins else np.zeros(0)
    c = g[(m >= CONTESTED[0]) & (m < CONTESTED[1])]
    return {"logit_gap_max": float(g.max()) if g.size else None,
            "contested_gap_ms": float((c * c).mean()) if c.size else None,
            "contested_gap_mean": float(c.mean()) if c.size else None,
            "contested_positions": int(c.size),
            "not_first": int((g > 0).sum()), "served": int(g.size)}


def load_limits(cell: str, root: Path = HERE) -> dict:
    path = root / "limits" / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def check(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for each number compared, in order, and
    whether all are within their limits (a number without a limit fails)."""
    out, ok = {}, True
    for name, value in readings.items():
        lim = limits.get(name, {}).get("limit")
        out[name] = {"value": value, "limit": lim}
        ok &= lim is not None and value is not None and value <= lim
    return {"checks": out, "correct": bool(ok)}
