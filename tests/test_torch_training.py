"""The port's training path against the JAX package's, on the same weights
(``params_from_numpy``) and the same numpy-seeded batches: teacher-forced
``forward`` logits and the MoE aux terms, and the loss and per-leaf
gradients of ``loss_fn`` against ``jax.value_and_grad(loss_fn)`` for the
seven reduced models of the card's parity phase; ``adamw_update`` against
the JAX one, and the twins of ``tests/test_training.py``'s optimizer
tests.

Tolerances, measured on these inputs before they were set (JAX jitted on
the CPU, the port eager on the CPU):
- logits: bf16 activations through 2 layers, at most 0.039-0.047 apart
  (griffin 0.071); the dense family's LOGIT_ATOL of 0.1
  (tests/test_torch_model.py). rwkv6's logits lie 0.161 apart, and the
  JAX package's own jitted and eager forwards lie 0.172 apart on the same
  batch (the port against the eager one: 0.063): its bound is 0.25.
- gradients, each leaf's relative L2 error: 1.35-2.36% (rwkv6 4.60%). On
  whisper two groups: the leaves whose gradient crosses the fp8 cast of
  the cross K/V (the cross K/V projections ``dec/xwk``, ``dec/xwv``,
  ``dec/xbv`` and the encoder upstream of them, ``enc/*``, ``enc_ln*``),
  where the cotangent is rounded to fp8 in both frameworks, at most 11.06%
  (``dec/xwv``; the encoder 8.5-10.4%); every other leaf at most 3.69%
  (``dec/xwq``). That is the JAX package's own spread: its jitted
  gradients differ from its eager ones by up to 4.2% (rwkv6) and 10.2%
  (whisper's encoder) on a 2 x 40 batch. GRAD_RTOL holds each model, and
  FP8_PATH_RTOL whisper's fp8 group, to about twice its measured error.
- the global gradient norm within GNORM_RTOL (measured at most 3.0e-3;
  without the largest leaf it moves 14-81%).
- the loss within LOSS_ATOL (measured at most 1.8e-3).
MoE routes: a token whose top-k experts differ between the two runs is a
flip; a flip is allowed only at a router near-tie (``ROUTE_TIE``, the
card's parity rule), where the port is pinned to the JAX route (the two
near-equal logits swapped), so one tie does not cascade through the
per-row capacity into other tokens' routes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.training import adamw_init as jadamw_init  # noqa: E402
from repro.training import adamw_update as jadamw_update  # noqa: E402
from repro.training.train import loss_fn as jloss_fn  # noqa: E402

import repro_torch.models.moe as moe  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.data import TrainPipeline  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import (AdamWState, adamw_init,  # noqa: E402
                                  adamw_update)
from repro_torch.training.train import loss_and_grads  # noqa: E402

PARITY = ["qwen3-4b-reduced", "deepseek-v2-lite-16b-reduced",
          "mixtral-8x22b-reduced", "internvl2-2b-reduced",
          "recurrentgemma-9b-reduced", "rwkv6-7b-reduced",
          "whisper-small-reduced"]
LOGIT_ATOL = {"rwkv6-7b-reduced": 0.25}
LOSS_ATOL = 1e-2
GNORM_RTOL = 1e-2
GRAD_RTOL = {"qwen3-4b-reduced": 0.04, "deepseek-v2-lite-16b-reduced": 0.04,
             "mixtral-8x22b-reduced": 0.04, "internvl2-2b-reduced": 0.04,
             "recurrentgemma-9b-reduced": 0.05, "rwkv6-7b-reduced": 0.1,
             "whisper-small-reduced": 0.075}
FP8_PATH_RTOL = 0.2
ROUTE_TIE = 2 ** -9
B, S = 2, 32


def _batch(cfg, seed=0):
    """A ``TrainPipeline`` batch, with bf16-exact random patches (vlm) or
    frames (whisper) as f32 numpy."""
    b = dict(TrainPipeline(cfg.vocab_size, B, S, seed=seed).next_batch())
    rng = np.random.default_rng(seed + 1)
    shape = {"vlm": (B, cfg.num_patches, cfg.d_model),
             "whisper": (B, cfg.num_frames, cfg.d_model)}.get(cfg.family)
    if shape:
        x = torch.from_numpy(rng.normal(0, 1, shape)).to(torch.bfloat16)
        b["patches" if cfg.family == "vlm" else "frames"] = x.float().numpy()
    return b


def _jax_batch(b):
    return {k: jnp.asarray(v, jnp.bfloat16 if v.dtype.kind == "f"
                           else jnp.int32) for k, v in b.items()}


def _torch_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        torch.bfloat16 if v.dtype.kind == "f" else torch.int32)
        for k, v in b.items()}


def _top_sets(probs, k):
    order = np.argsort(-probs, axis=-1, kind="stable")
    return np.sort(order[..., :k], -1), -np.sort(-probs, -1)


class _PinRoutes:
    """The port's ``moe._route`` pinned to recorded JAX routes at near-ties
    (see the module docstring); other flips are collected in ``bad``."""

    def __init__(self, ref):
        self.ref, self.pinned, self.bad = ref, [], []

    def __enter__(self):
        self.orig = moe._route
        moe._route = self
        return self

    def __exit__(self, *exc):
        moe._route = self.orig

    def __call__(self, logits, top_k, capacity, with_aux=False):
        probs = torch.softmax(logits.detach().float(), -1).numpy()
        ref = min((r for r in self.ref if r.shape == probs.shape),
                  key=lambda r: np.abs(r - probs).max())
        mine, _ = _top_sets(probs, top_k)
        want, srt = _top_sets(ref, top_k)
        moved = np.argwhere((mine != want).any(-1))
        if len(moved):
            logits = logits.clone()
        for b, s in moved:
            gap = float(srt[b, s, top_k - 1] - srt[b, s, top_k])
            out = sorted(set(mine[b, s]) - set(want[b, s]))
            inn = sorted(set(want[b, s]) - set(mine[b, s]))
            if gap > ROUTE_TIE or len(out) != 1:
                self.bad.append(gap)
                continue
            self.pinned.append(gap)
            logits[b, s, [out[0], inn[0]]] = logits[b, s, [inn[0], out[0]]]
        return self.orig(logits, top_k, capacity, with_aux=with_aux)


def _jax_run(arch, jparams, jb, mode="coopt"):
    """(logits, aux, loss, metrics, grads, router probs of every MoE call)
    from one jitted call: the forward and ``value_and_grad(loss_fn)``."""
    jm = jget_model(jget_config(arch))
    coopt = JMODES[mode]
    routes = []
    orig = jmoe._route

    def spy(logits, k, c):
        jax.debug.callback(lambda lg: routes.append(np.asarray(
            jax.nn.softmax(np.asarray(lg, np.float32), -1))), logits)
        return orig(logits, k, c)

    def run(p):
        logits, aux = jm.forward(p, jb, coopt)
        vg = jax.value_and_grad(lambda q: jloss_fn(jm, q, jb, coopt),
                                has_aux=True)(p)
        return logits, aux, vg
    jmoe._route = spy
    try:
        logits, aux, ((loss, metrics), grads) = jax.jit(run)(jparams)
        jax.block_until_ready(grads)
    finally:
        jmoe._route = orig
    return logits, aux, loss, metrics, grads, routes


@pytest.fixture(scope="module", params=PARITY)
def parity(request):
    arch = request.param
    cfg = get_config(arch)
    jparams = jget_model(jget_config(arch)).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    host = _batch(cfg)
    return (arch, cfg, params, host) + _jax_run(arch, jparams,
                                                _jax_batch(host))


def grad_tol(arch, path):
    """The relative L2 bound of one leaf's gradient: GRAD_RTOL of the
    model, or FP8_PATH_RTOL for a whisper leaf behind the fp8 cross K/V."""
    if arch.startswith("whisper") and (
            path[0] in ("enc", "enc_ln", "enc_ln_b")
            or (path[0] == "dec" and path[1] in ("xwk", "xwv", "xbv"))):
        return FP8_PATH_RTOL
    return GRAD_RTOL[arch]


def _rel_l2(got, want):
    d = np.linalg.norm(got - want)
    n = np.linalg.norm(want)
    return 0.0 if d == 0 else d / max(n, 1e-30)


def test_forward_logits_and_aux_match_jax(parity):
    """Teacher-forced logits (vlm: the text positions only) within the
    LOGIT_ATOL of the JAX model's, coopt mode; the MoE aux terms summed over
    layers within 2%, as the router probabilities they average."""
    arch, cfg, params, host, jlogits, jaux, *_, routes = parity
    model = get_model(cfg)
    with _PinRoutes(routes) as pin, torch.no_grad():
        logits, aux = model.forward(params, _torch_batch(host),
                                    MODES["coopt"])
    assert not pin.bad, f"MoE routes flipped away from a tie: {pin.bad}"
    want = np.asarray(jlogits, np.float32)
    assert logits.shape == want.shape
    np.testing.assert_allclose(logits.float().numpy(), want,
                               atol=LOGIT_ATOL.get(arch, 0.1))
    assert set(aux) == (set(jaux) if jaux else set())
    for k, v in aux.items():
        np.testing.assert_allclose(float(v), float(jaux[k]), rtol=2e-2,
                                   atol=1e-3, err_msg=k)
    if cfg.num_experts:
        assert float(aux["load_balance"]) > 0


def test_loss_and_grads_match_jax(parity):
    """The loss and every leaf's gradient against ``jax.value_and_grad(
    loss_fn)``: each leaf within its relative L2 bound, the global norm
    within GNORM_RTOL. Controls: the labels rolled by one along the
    sequence must break the leaf bound; the norm without the largest leaf
    must break the norm bound."""
    arch, cfg, params, host, _, _, jloss, jmet, jgrads, routes = parity
    model = get_model(cfg)
    with _PinRoutes(routes) as pin:
        met, grads = loss_and_grads(model, params, _torch_batch(host),
                                    MODES["coopt"])
        rolled = dict(host, labels=np.roll(host["labels"], 1, axis=1))
        _, grads_ctl = loss_and_grads(model, params, _torch_batch(rolled),
                                      MODES["coopt"])
    assert not pin.bad, f"MoE routes flipped away from a tie: {pin.bad}"
    assert abs(float(met["loss"]) - float(jloss)) <= LOSS_ATOL
    assert set(met) == set(jmet)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(grads)
    want = [np.asarray(g, np.float32) for _, g in flat]
    got = [g.float().numpy() for g in grads]
    paths = [p for p, _ in tree_util.leaves_with_path(params)]
    assert paths == [[getattr(k, "key", getattr(k, "idx", None)) for k in p]
                     for p, _ in flat]
    tol = [grad_tol(arch, p) for p in paths]
    rel = [_rel_l2(a, w) for a, w in zip(got, want)]
    over = [(p, r, t) for p, r, t in zip(paths, rel, tol) if r > t]
    assert not over, f"leaves over their bound: {over}"
    ctl = [_rel_l2(g.float().numpy(), w) for g, w in zip(grads_ctl, want)]
    assert any(c > t for c, t in zip(ctl, tol)), \
        "the gradient check missed the rolled labels"
    sq = [float(np.sum(np.square(a))) for a in got]
    gn_want = np.sqrt(sum(float(np.sum(np.square(w))) for w in want))
    assert abs(np.sqrt(sum(sq)) - gn_want) <= GNORM_RTOL * gn_want
    assert abs(np.sqrt(sum(sq) - max(sq)) - gn_want) > GNORM_RTOL * gn_want


@pytest.mark.parametrize("arch", ["qwen3-4b-reduced",
                                  "whisper-small-reduced"])
def test_forward_original_mode_matches_jax(arch):
    """Original mode (K/V expanded per query head; whisper's cross K/V in
    bf16): the logits within 0.1 of the JAX model's."""
    cfg = get_config(arch)
    jm = jget_model(jget_config(arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    host = _batch(cfg)
    want, _ = jax.jit(lambda p, b: jm.forward(p, b, JMODES["original"]))(
        jparams, _jax_batch(host))
    with torch.no_grad():
        got, _ = get_model(cfg).forward(params, _torch_batch(host),
                                        MODES["original"])
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.1)


# ------------------------------------------------------------- AdamW --
def _opt_trees(rng):
    """params (f32 and bf16 leaves, nested as a model's), grads (scaled so
    the global norm clips) as numpy f32."""
    shapes = {"w": (64, 48), "b": (48,), "seg": [{"a": (3, 32, 16)},
                                                 {"a": (2, 8)}]}

    def draw(sh):
        if isinstance(sh, dict):
            return {k: draw(v) for k, v in sh.items()}
        if isinstance(sh, list):
            return [draw(v) for v in sh]
        return rng.normal(0, 1, sh).astype(np.float32)
    return draw(shapes), jax.tree.map(lambda g: 3.0 * g, draw(shapes))


def test_adamw_matches_jax():
    """Three AdamW steps with clipping active on the same params and grads:
    f32 leaves within 2 f32 ulps of the JAX update (XLA's pow and fused
    sums round differently), bf16 leaves within one bf16 ulp; the moments
    alike, the step count and the grad norm."""
    rng = np.random.default_rng(0)
    p_np, g_np = _opt_trees(rng)
    bf = {"b", "a"}                          # these leaves in bf16

    def jleaf(path, x):
        return jnp.asarray(x, jnp.bfloat16 if path[-1].key in bf
                           else jnp.float32)

    def tleaf(path, x):
        return torch.from_numpy(x.copy()).to(
            torch.bfloat16 if path[-1].key in bf else torch.float32)
    jp = jax.tree_util.tree_map_with_path(jleaf, p_np)
    tp = jax.tree_util.tree_map_with_path(tleaf, p_np)
    jst, tst = jadamw_init(jp), adamw_init(tp)
    for i in range(3):
        grads = jax.tree.map(lambda g: g * (1 + i), g_np)
        jg = jax.tree_util.tree_map_with_path(jleaf, grads)
        tg = jax.tree_util.tree_map_with_path(tleaf, grads)
        jp, jst, jn = jadamw_update(jp, jg, jst, lr=1e-2)
        tp, tst, tn = adamw_update(tp, tg, tst, lr=1e-2)
        assert float(jn) > 1.0                       # clipping is active
        np.testing.assert_allclose(float(tn), float(jn), rtol=2e-6)
    assert int(tst.step) == int(jst.step) == 3
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            tree_util.leaves(tp)):
        a32 = np.asarray(a, np.float32)
        b32 = b.float().numpy()
        if a.dtype == jnp.bfloat16:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(a32) + 1e-30)) - 7)
            assert np.all(np.abs(b32 - a32) <= ulp), path
        else:
            np.testing.assert_allclose(b32, a32, rtol=2 * 2 ** -23,
                                       atol=1e-7, err_msg=str(path))
    for jt, tt in ((jst.mu, tst.mu), (jst.nu, tst.nu)):
        for a, b in zip(jax.tree.leaves(jt), tree_util.leaves(tt)):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=4e-6,
                                       atol=1e-12)


def test_adamw_moves_against_gradient():
    p = {"w": torch.ones(4)}
    st = adamw_init(p)
    p2, st2, gn = adamw_update(p, {"w": torch.ones(4)}, st, lr=0.1,
                               weight_decay=0.0)
    assert torch.all(p2["w"] < 1.0)
    assert float(gn) == pytest.approx(2.0)
    assert int(st2.step) == 1
    assert isinstance(st2, AdamWState)


def test_grad_clip_bounds_update():
    p = {"w": torch.zeros(2)}
    st = adamw_init(p)
    p2, _, _ = adamw_update(p, {"w": torch.full((2,), 1e6)}, st, lr=0.1,
                            grad_clip=1.0, weight_decay=0.0)
    assert torch.all(p2["w"].abs() <= 0.11)


def test_weight_decay_shrinks_weights():
    p = {"w": torch.full((4,), 10.0)}
    st = adamw_init(p)
    p2, _, _ = adamw_update(p, {"w": torch.zeros(4)}, st, lr=0.1,
                            weight_decay=0.5)
    assert torch.all(p2["w"] < 10.0)
