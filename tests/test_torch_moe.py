"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's,
on the same numpy-seeded inputs: routing (``_route``) exactly, the FFN
output within a stated tolerance, with dropped tokens and shared experts.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402

from repro_torch.models import moe  # noqa: E402

# The expert products run in bf16 with f32 accumulation on both sides and
# round once per matmul; the combine scatter-adds up to top_k bf16 terms per
# token in bf16. Outputs of |y| ~ 1 may differ by a few bf16 ulps (2**-8 to
# 2**-7 each). Measured on these inputs: at most 0.0156.
MOE_ATOL = 2 ** -5
# combine weights: softmax then renormalisation over the top-k, a few f32
# roundings, each of which may land one ulp apart across the frameworks
COMB_ULP = 4


def _logits(rng, B, S, E, ties):
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    if ties:
        # exact ties across experts, inside and at the edge of the top-k
        x[:, ::3, 1] = x[:, ::3, 2] = x[:, ::3, E - 1] = 2.0
        x[:, 1::4, :] = 0.5                          # a token with all equal
    return x


@pytest.mark.parametrize("B,S,E,K,cap", [(2, 16, 8, 2, 5), (1, 9, 4, 2, 9),
                                         (3, 1, 64, 6, 1)])
@pytest.mark.parametrize("ties", [False, True])
def test_route_matches_jax_exactly(B, S, E, K, cap, ties):
    """Same router logits -> equal token slots (pad index S for an empty
    slot) and equal combine weights up to the softmax's rounding (XLA and
    PyTorch evaluate exp with different f32 polynomials, a last-bit
    difference: COMB_ULP). Ties go to the lower expert index in both
    (jax.lax.top_k; a stable descending sort here). The first case drops
    tokens: 16 tokens x 2 choices over 8 experts exceed capacity 5."""
    x = _logits(np.random.default_rng(0), B, S, E, ties)
    jidx, jcomb, aux = jmoe._route(jnp.asarray(x), K, cap)
    idx, comb = moe._route(torch.from_numpy(x), K, cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(comb.numpy() == 0, np.asarray(jcomb) == 0)
    np.testing.assert_array_max_ulp(comb.numpy(), np.asarray(jcomb),
                                    maxulp=COMB_ULP)
    if (B, S, cap) == (2, 16, 5):
        assert float(aux.dropped_fraction) > 0


@pytest.mark.parametrize("S,cf,shared", [(12, 1.25, True), (12, 0.5, True),
                                         (1, 1.25, True), (7, 1.25, False)])
def test_moe_ffn_matches_jax(S, cf, shared):
    """moe_ffn within MOE_ATOL of the JAX FFN; cf 0.5 drops tokens (capacity
    below the routed load) and S = 1 is a decode step (capacity 1)."""
    rng = np.random.default_rng(1)
    B, d, E, ff, K = 2, 64, 4, 32, 2
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) / math.sqrt(s[-2])
          for s in ((d, E), (E, d, ff), (E, d, ff), (E, ff, d))]
    sh = [rng.standard_normal(s).astype(np.float32) / math.sqrt(s[0])
          for s in ((d, 2 * ff), (d, 2 * ff), (2 * ff, d))]
    jb = [jnp.asarray(w, jnp.bfloat16) for w in [x] + ws + sh]
    tb = [torch.from_numpy(w).to(torch.bfloat16) for w in [x] + ws + sh]
    want, aux = jmoe.moe_ffn(*jb[:5], top_k=K, capacity_factor=cf,
                             shared=tuple(jb[5:]) if shared else None)
    got = moe.moe_ffn(*tb[:5], top_k=K, capacity_factor=cf,
                      shared=tuple(tb[5:]) if shared else None)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, d)
    if cf < 1:
        assert float(aux.dropped_fraction) > 0
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=MOE_ATOL)
