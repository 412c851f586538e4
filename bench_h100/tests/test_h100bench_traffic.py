"""The traffic mixes: made from the seed alone, the same work on every seed."""
from itertools import islice
from pathlib import Path

import numpy as np
import pytest

from bench_h100 import traffic

BENCH = Path(traffic.__file__).resolve().parent
MIXES = ("sharegpt-poisson", "sharegpt-closed32")


def take(mix, seed, n=64, vocab=1000):
    return list(islice(traffic.requests(traffic.load_mix(mix), vocab, seed),
                       n))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a, b = take(mix, 2**31 + 77), take(mix, 2**31 + 77)
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
               for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES)
def test_chat_mixes_have_no_shared_prefix(mix):
    heads = {tuple(r.prompt[:4]) for r in take(mix, 1) if len(r.prompt) >= 4}
    assert len(heads) == len([r for r in take(mix, 1) if len(r.prompt) >= 4])


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_other_requests(mix):
    a, b = take(mix, 5), take(mix, 6)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES)
def test_every_block_holds_the_same_sizes(mix):
    k = traffic.load_mix(mix)["requests"]["block"]
    for seed in (1, 2**40 + 3):
        reqs = take(mix, seed, 3 * k)
        blocks = [reqs[i * k:(i + 1) * k] for i in range(3)]
        sizes = [(sorted(len(r.prompt) for r in b),
                  sorted(r.max_new for r in b)) for b in blocks]
        assert sizes[0] == sizes[1] == sizes[2]
        assert sizes[0] == (sorted(len(r.prompt) for r in take(mix, 9, k)),
                            sorted(r.max_new for r in take(mix, 9, k)))


def test_sharegpt_lengths_follow_the_frozen_model():
    st = traffic.ShareGPTStats()
    reqs = take("sharegpt-closed32", 3, 32)
    plens = [len(r.prompt) for r in reqs]
    outs = [r.max_new for r in reqs]
    assert st.min_prompt <= min(plens) and max(plens) <= st.max_prompt
    assert st.min_output <= min(outs) and max(outs) <= st.max_output
    # medians near exp(5.1) and exp(5.5)
    assert 120 < np.median(plens) < 220 and 190 < np.median(outs) < 320


def test_poisson_offsets_are_the_same_on_every_seed():
    mix = {"arrivals": {"kind": "poisson", "rate_per_s": 2.0},
           "requests": {"block": 32}}
    a = list(islice(traffic.arrival_offsets(mix), 96))
    assert a == list(islice(traffic.arrival_offsets(mix), 96))
    # the first block (the lead-in) ends as the window opens; the next
    # starts there, 16 s long, in another order
    assert a[0] == -16.0 and a[31] < 0
    for i in (32, 64):                  # exact: no drift at the close
        assert a[i] == i / 2 - 16
    gaps = np.diff(a)
    assert not np.allclose(gaps[:31], gaps[32:63])


@pytest.mark.parametrize("mix", MIXES)
def test_every_block_is_in_the_same_order_on_every_seed(mix):
    k = traffic.load_mix(mix)["requests"]["block"]
    a, b = take(mix, 1, 3 * k), take(mix, 2**33, 3 * k)
    assert [(len(r.prompt), r.max_new) for r in a] == \
        [(len(r.prompt), r.max_new) for r in b]
    # the blocks are ordered apart from each other
    assert [len(r.prompt) for r in a[:k]] != [len(r.prompt) for r in a[k:2 * k]]


def test_stratified_spreads_the_largest():
    from bench_h100.traffic import rng_for, stratified
    for seed in (1, 2**40):
        p = stratified(rng_for(seed, 1), 40, 8)
        assert sorted(p) == list(range(40))
        for run in p.reshape(5, 8):          # one of each stratum a run
            assert sorted(run // 5) == list(range(8))
