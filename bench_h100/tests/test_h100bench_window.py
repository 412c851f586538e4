"""The window arithmetic of the end-to-end metrics."""
import numpy as np
import pytest

from bench_h100.window import ClientRecord, e2e


def client(idx, due, first, gap, n):
    r = ClientRecord(idx=idx, due=due, max_new=n, prompt=np.zeros(4, "int32"))
    r.times = [first + i * gap for i in range(n)]
    return r


def steady(stall_at=None, stall=0.0):
    """Ten requests due 1 s apart from t=10, first token 0.2 s after due,
    then a token every 0.05 s; a stall delays every token after it."""
    out = []
    for i in range(10):
        r = client(i, 10.0 + i, 10.2 + i, 0.05, 40)
        if stall_at is not None:
            r.times = [t + stall if t >= stall_at else t for t in r.times]
        out.append(r)
    return out


def test_steady_window():
    m = e2e(steady(), 10.0, 20.0)
    assert m["ttft_p90_ms"] == pytest.approx(200.0)
    assert m["tpot_p90_ms"] == pytest.approx(50.0)
    assert m["attempted"] == 10 and m["failed"] == 0


def test_a_stall_moves_both_tails():
    base = e2e(steady(), 10.0, 20.0)
    hit = e2e(steady(stall_at=15.15, stall=3.0), 10.0, 20.0)
    assert hit["ttft_p90_ms"] > base["ttft_p90_ms"] + 1000
    assert hit["tpot_p90_ms"] > base["tpot_p90_ms"] * 1.5
    assert hit["output_tok_s"] < base["output_tok_s"]


def test_tokens_outside_the_window_do_not_count():
    recs = steady()
    inside = e2e(recs, 10.0, 20.0)
    late = client(10, 25.0, 25.1, 0.01, 100)       # due and served after
    early = client(11, 0.0, 0.1, 0.01, 100)        # served before
    both = e2e(recs + [late, early], 10.0, 20.0)
    assert both["output_tok_s"] == inside["output_tok_s"]
    assert both["attempted"] == inside["attempted"]
    assert both["tpot_p90_ms"] == inside["tpot_p90_ms"]


def test_ttft_is_timed_from_due_and_followed_past_the_close():
    r = client(0, 19.5, 23.5, 0.05, 3)             # due inside, served after
    m = e2e([r], 10.0, 20.0)
    assert m["ttft_p90_ms"] == pytest.approx(4000.0)
    assert m["output_tok_s"] == 0.0


def test_a_request_with_no_token_counts_failed():
    r = ClientRecord(idx=0, due=12.0, max_new=4, prompt=np.zeros(4, "int32"))
    m = e2e(steady() + [r], 10.0, 20.0)
    assert m["failed"] == 1 and m["attempted"] == 11
