"""The port's data pipelines (``repro_torch.data``): twins of
``tests/test_data.py``, and the same requests and training batches as the
JAX package's ``repro.data`` for the same seeds and scales."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import data as jdata  # noqa: E402

from repro_torch.data import (RequestStream, TrainPipeline,  # noqa: E402
                              sharegpt_stream, train_batches)


def test_request_stream_deterministic():
    a = sharegpt_stream(1000, 5, seed=42)
    b = sharegpt_stream(1000, 5, seed=42)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt, y.prompt)
        assert x.max_new_tokens == y.max_new_tokens


def test_request_lengths_plausible():
    reqs = sharegpt_stream(1000, 200, seed=0)
    plens = np.array([r.prompt_len for r in reqs])
    assert plens.min() >= 2 and plens.max() <= 2048
    med = np.median(plens)
    assert 60 <= med <= 400       # ShareGPT-ish median


def test_scale_shrinks_lengths():
    big = sharegpt_stream(1000, 50, seed=1, scale=1.0)
    small = sharegpt_stream(1000, 50, seed=1, scale=0.1)
    assert np.median([r.prompt_len for r in small]) < \
        np.median([r.prompt_len for r in big])


def test_train_pipeline_shapes_and_structure():
    p = TrainPipeline(vocab_size=128, batch=4, seq_len=16, seed=0)
    b = p.next_batch()
    assert b["tokens"].shape == (4, 16) and b["labels"].shape == (4, 16)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 128
    b2 = p.next_batch()
    assert not np.array_equal(b["tokens"], b2["tokens"])


def test_train_pipeline_learnable_structure():
    """85% of transitions follow the fixed bigram table => the conditional
    entropy is well below log(V)."""
    p = TrainPipeline(vocab_size=64, batch=8, seq_len=256, seed=3)
    b = p.next_batch()
    toks, labels = b["tokens"], b["labels"]
    follows = 0
    for bb in range(8):
        succ = p._succ[toks[bb]]
        follows += np.mean(np.any(succ == labels[bb][:, None], axis=1))
    assert follows / 8 > 0.8


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 0.15), (7, 0.25),
                                        (42, 0.05)])
def test_requests_match_jax(seed, scale):
    """The same seed and scale give the same prompts, lengths and request
    ids, through ``RequestStream.take`` (fixed and drawn output lengths)
    and ``sharegpt_stream``."""
    mine = RequestStream(92553, seed=seed, scale=scale)
    ref = jdata.RequestStream(92553, seed=seed, scale=scale)
    got = mine.take(6, max_new_tokens=32) + mine.take(6)
    want = ref.take(6, max_new_tokens=32) + ref.take(6)
    got += sharegpt_stream(32768, 8, seed=seed, scale=scale)
    want += jdata.sharegpt_stream(32768, 8, seed=seed, scale=scale)
    for a, b in zip(got, want):
        assert (a.req_id, a.max_new_tokens, a.prompt_len) == \
            (b.req_id, b.max_new_tokens, b.prompt_len)
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)


@pytest.mark.parametrize("seed", [0, 5])
def test_train_batches_match_jax(seed):
    got = list(train_batches(100, 3, 12, steps=3, seed=seed))
    want = list(jdata.train_batches(100, 3, 12, steps=3, seed=seed))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])
