"""The port's dense ``TransformerModel`` against the JAX package's, on the
same weights (``params_from_numpy``) and the same numpy-seeded inputs:
chunked prefill, a continuation chunk and a decode step, in all five modes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "qwen3-4b-reduced"
# bf16 activations through 2 layers: XLA evaluates the scanned layer's
# fused elementwise chains and softmax with other roundings than eager
# PyTorch, so most logits differ by a few bf16 ulps (|logit| < 4, ulp
# 2**-6). With FP8 a one-ulp change of a K/V element can move its fp8 code
# one step (1/16 relative). Measured on these inputs: at most 0.031 without
# FP8 and 0.066 with it.
LOGIT_ATOL = 0.1


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config(ARCH)
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, params_from_numpy(get_config(ARCH), tree, "cpu")


def _steps(rng, vocab):
    """Three engine-style steps on two lanes of a lane-identity pool with
    16-token pages: (kind, host batch). Pads repeat the last position and
    write nowhere (slot -1)."""
    P_lane, ps = 4, 16
    lens = [20, 12]
    S = 24
    toks = rng.integers(0, vocab, (2, S)).astype(np.int32)
    pos = np.stack([np.minimum(np.arange(S), n - 1) for n in lens])
    slot = np.stack([np.where(np.arange(S) < n, b * P_lane * ps + pos[b], -1)
                     for b, n in enumerate(lens)])
    yield "prefill", dict(tokens=toks, positions=pos, slot_idx=slot,
                          cache_len=np.array(lens),
                          last_pos=np.array([n - 1 for n in lens]))
    # lane 0 continues with an 8-token chunk, lane 1 is a decode lane
    S2 = 8
    toks2 = rng.integers(0, vocab, (2, S2)).astype(np.int32)
    pos2 = np.stack([20 + np.arange(S2), np.full(S2, 12)])
    slot2 = np.stack([pos2[0], np.r_[P_lane * ps + 12, [-1] * (S2 - 1)]])
    yield "prefill", dict(tokens=toks2, positions=pos2, slot_idx=slot2,
                          cache_len=np.array([28, 13]),
                          last_pos=np.array([S2 - 1, 0]))
    tok3 = rng.integers(0, vocab, (2, 1)).astype(np.int32)
    pos3 = np.array([[28], [13]])
    yield "decode", dict(token=tok3, positions=pos3,
                         slot_idx=np.array([[28], [P_lane * ps + 13]]),
                         cache_len=np.array([29, 14]))


CASES = [(mode, 0) for mode in MODES] + [("coopt", 16)]


@pytest.mark.parametrize("mode,long_window", CASES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_and_decode_logits_match_jax(weights, mode, long_window,
                                             use_kernel):
    """Logits of every step within LOGIT_ATOL of the JAX model's (JAX on
    its jnp reference path), in all five modes and with the block-sparse
    ``long_window`` policy; with ``use_kernel`` the port runs its kernel
    wrappers, which on CPU tensors take their plain versions."""
    jparams, params = weights
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    coopt = MODES[mode].replace(page_size=16, use_kernel=use_kernel)
    jcoopt = JMODES[mode].replace(page_size=16)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    cache = model.init_cache(2, 64, coopt, device="cpu")
    jcache = jmodel.init_cache(2, 64, jcoopt)
    rng = np.random.default_rng(0)
    for kind, host in _steps(rng, cfg.vocab_size):
        jb = {k: jnp.asarray(v, jnp.int32) for k, v in host.items()}
        tb = {k: torch.from_numpy(np.asarray(v, np.int32))
              for k, v in host.items()}
        step = "prefill" if kind == "prefill" else "decode_step"
        jl, jcache = getattr(jmodel, step)(jparams, jb, jcache, jcoopt,
                                           long_window=long_window)
        tl, cache = getattr(model, step)(params, tb, cache, coopt,
                                         long_window=long_window)
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32),
                                   atol=LOGIT_ATOL)
        np.testing.assert_array_equal(cache["length"].numpy(),
                                      np.asarray(jcache["length"]))


def test_full_prefill_matches_jax(weights):
    """The non-chunked prefill (full causal attention) matches JAX. With
    ``use_kernel`` it runs K8, flash_prefill (test below; on the card in
    tests/test_torch_cuda.py)."""
    jparams, params = weights
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    coopt = MODES["coopt"].replace(page_size=16)
    toks = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(np.int32)
    jl, _ = jget_model(jcfg).prefill(
        jparams, {"tokens": jnp.asarray(toks)},
        jget_model(jcfg).init_cache(2, 64, JMODES["coopt"].replace(
            page_size=16)), JMODES["coopt"].replace(page_size=16))
    tl, _ = get_model(cfg).prefill(
        params, {"tokens": torch.from_numpy(toks)},
        get_model(cfg).init_cache(2, 64, coopt, device="cpu"), coopt)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("mode", ["coopt", "original"])
def test_full_prefill_kernel_path_matches_jax(weights, mode):
    """The full-prompt prefill with ``use_kernel``: the port's K8 wrapper
    (its plain version on CPU tensors) against JAX's flash_prefill kernel in
    interpret mode; ``original`` expands K/V per query head (G = 1)."""
    jparams, params = weights
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    coopt = MODES[mode].replace(page_size=16, use_kernel=True)
    jcoopt = JMODES[mode].replace(page_size=16, use_kernel=True)
    toks = np.random.default_rng(2).integers(0, 512, (2, 32)).astype(np.int32)
    jmodel, model = jget_model(jcfg), get_model(cfg)
    jl, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                jmodel.init_cache(2, 64, jcoopt), jcoopt)
    tl, cache = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                              model.init_cache(2, 64, coopt, device="cpu"),
                              coopt)
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_ATOL)
    np.testing.assert_array_equal(cache["length"].numpy(),
                                  np.asarray(jcache["length"]))


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    model = get_model(get_config(ARCH))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(2, 64, MODES["coopt"])
    # whisper, the last family to arrive, is served and takes the card too
    whisper = get_model(get_config("whisper-small-reduced"))
    assert type(whisper).__name__ == "WhisperModel"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        whisper.init_cache(2, 64, MODES["coopt"])
    with pytest.raises(NotImplementedError):
        get_model(get_config(ARCH).replace(family="unknown"))


def test_param_init_is_seeded_and_fan_in_scaled():
    model = get_model(get_config(ARCH))
    a, b = model.init(7, "cpu"), model.init(7, "cpu")
    assert torch.equal(a["segments"][0]["wq"], b["segments"][0]["wq"])
    wq = a["segments"][0]["wq"].float()
    assert abs(wq.std().item() - 256 ** -0.5) < 0.01
    assert a["segments"][0]["ln1"].dtype == torch.float32
    assert model.param_count() == sum(
        t.numel() for t in [a["embed"], a["final_norm"], a["lm_head"]]
        + list(a["segments"][0].values()))
