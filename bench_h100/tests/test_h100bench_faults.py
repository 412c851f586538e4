"""A run with the timed path broken underneath comes out not correct, once
for each fault a served cell can have; the same run unbroken is correct.
(One card: no exchange between chips to leave out.)"""
import pytest
import torch

import tiny


def state_unchanged(ae):
    """Every step leaves the cache as it was: no K/V (or latent) write."""
    ae.engine.model._write_layer = lambda *a, **k: None


def token_altered(ae):
    """Each sampled token is altered where it is produced (the next step
    still reads the true one)."""
    eng = ae.engine
    step = eng._async_step

    def altered(kind, inp):
        logits, toks = step(kind, inp)
        return logits, (toks + 1) % eng.cfg.vocab_size
    eng._async_step = altered


def half_batch(ae):
    """Half of each step's rows is left out: the first half's rows take the
    second half's logits. (The first lanes are the ones a light load
    fills, so the fault shows at any load.)"""
    eng = ae.engine
    fwd = eng._forward

    def half(kind, batch, lane_mask):
        logits = fwd(kind, batch, lane_mask)
        n = logits.shape[0] // 2
        return torch.cat([logits[-n:], logits[n:]])
    eng._forward = half


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("cell", ["tiny-dense-poisson", "tiny-mla-closed"])
def test_unbroken_run_is_correct(root, cell):
    assert tiny.run(root, cell).result["correct"]


@pytest.mark.parametrize("fault", [state_unchanged, token_altered,
                                   half_batch])
@pytest.mark.parametrize("cell", ["tiny-dense-poisson", "tiny-mla-closed"])
def test_fault_is_not_correct(root, cell, fault):
    out = tiny.run(root, cell, fault=fault)
    assert not out.result["correct"], out.checks
    assert out.result["checks"]["contested_gap_ms"]["value"] > \
        tiny.LIMITS["contested_gap_ms"]["limit"]
