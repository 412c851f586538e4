"""The port's training loop, launcher and example: the twins of
``tests/test_arch_smoke.py``'s forward and train-step cells and of its
teacher-forcing check against prefill + decode for every architecture
(reduced), of ``tests/test_microbatch.py`` (and the port's microbatched
step against the JAX one), of ``tests/test_training.py``'s loop cells, three
``Trainer`` steps against the JAX ``Trainer`` from the same weights,
``launch.train`` (its checkpoint loads in the JAX package) and
``examples.train_small``; the guard that refuses a gradient through a
hand-written kernel, beside the JAX package's refusal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import COOPT as JCOOPT  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import adamw_init as jadamw_init  # noqa: E402
from repro.training.train import loss_fn as jloss_fn  # noqa: E402
from repro.training.train import make_train_step as jmake_step  # noqa: E402

from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.configs import ALL_IDS, InputShape, get_config  # noqa: E402
from repro_torch.core.coopt import COOPT  # noqa: E402
from repro_torch.data import TrainPipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        params_to_numpy)
from repro_torch.training import (Trainer, adamw_init,  # noqa: E402
                                  make_train_step)
from repro_torch.training.train import (loss_and_grads,  # noqa: E402
                                        step_grads)

ARCH = "qwen3-4b-reduced"


def _batch(model, cfg, B, S, seed):
    """Inputs of ``input_specs`` (kind train): tokens and labels from a
    numpy generator, float inputs (patches, frames) normal in their dtype."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shape, dtype) in model.input_specs(
            InputShape("t", S, B, "train")).items():
        if dtype == torch.int32:
            out[k] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, shape).astype(np.int32))
        else:
            out[k] = torch.from_numpy(rng.normal(0, 1, shape)).to(dtype)
    return out


@pytest.mark.parametrize("arch", ALL_IDS)
def test_forward_shapes_and_finite(arch):
    cfg = get_config(arch + "-reduced")
    m = get_model(cfg)
    p = m.init(0, "cpu")
    B, S = 2, 64
    with torch.no_grad():
        logits, _ = m.forward(p, _batch(m, cfg, B, S, 1), COOPT)
    S_text = S - (cfg.num_patches if cfg.family == "vlm" else 0)
    assert logits.shape == (B, S_text, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", ALL_IDS)
def test_one_train_step(arch):
    cfg = get_config(arch + "-reduced")
    tr = Trainer(cfg, lr=1e-3, device="cpu")
    metrics = tr.step(_batch(tr.model, cfg, 2, 32, 2))
    assert np.isfinite(metrics["loss"]) and metrics["loss"] > 0
    assert np.isfinite(metrics["grad_norm"])
    assert int(tr.opt_state.step) == 1


@pytest.mark.parametrize("arch", ALL_IDS)
def test_decode_consistency_with_forward(arch):
    """The port's teacher-forced logits against its own prefill and decode
    on the same tokens: the prefill's last-token logits equal the forward's
    at that position, and a decode of the held-out token the forward's at
    the next, within the reference cell's 0.15 x max |logit| (fp8 cache,
    bf16 skew; MoE at dropless capacity)."""
    cfg = get_config(arch + "-reduced")
    m = get_model(cfg)
    p = m.init(0, "cpu")
    B, S = 1, 24
    batch = _batch(m, cfg, B, S + 1, 5)
    batch.pop("labels")
    full = batch["tokens"]
    coopt = COOPT
    if cfg.num_experts:
        coopt = COOPT.replace(
            moe_capacity_factor=float(cfg.num_experts) / cfg.top_k)
    with torch.no_grad():
        fwd, _ = m.forward(p, dict(batch), coopt)
        pre = dict(batch, tokens=full[:, :-1])
        S_text = pre["tokens"].shape[1]
        cache = m.init_cache(B, S + 8, coopt, device="cpu")
        pl, cache = m.prefill(p, pre, cache, coopt)
        de, _ = m.decode_step(p, {"token": full[:, -1:]}, cache, coopt)
    a = fwd[:, S_text - 1].float().numpy()
    atol = 0.15 * max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(pl.float().numpy(), a, atol=atol)
    np.testing.assert_allclose(de.float().numpy(),
                               fwd[:, S_text].float().numpy(), atol=atol)


def _same_start():
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(get_config(ARCH),
                                      jax.tree.map(np.asarray, jparams), "cpu")


def _rel_l2(got, want):
    """Relative L2 error of a tensor against a tensor or an array."""
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# Microbatches, measured on this batch before the bounds were set: the
# accumulated gradients of 4 parts against the whole batch's at most 2.4e-3
# per leaf (relative L2), against JAX's whole-batch gradients 1.44e-2
# (test_torch_training.py holds this model to 0.04); grad norms within
# 1.6e-4 (n 4 against 1, and against JAX's n 4). The first microbatch's
# gradients alone lie 1.18-1.74 from the whole batch's, its norm 2x.
MICRO_GRAD_RTOL = 1e-2
JAX_GRAD_RTOL = 0.04
GNORM_RTOL = 1e-2


def test_microbatched_equals_monolithic():
    """4 microbatches against 1: the accumulated per-leaf gradients within
    MICRO_GRAD_RTOL, the step's grad norm within GNORM_RTOL, and the JAX
    test's bounds after the step (loss 5e-3, params atol and rtol 2e-2;
    one AdamW step moves a param by about lr whatever its gradient, so
    these alone do not see the accumulation). The port's 4 against the JAX
    package's 4 from the same weights and batch: loss, params and grad
    norm alike, and the port's accumulated gradients against
    ``jax.value_and_grad`` of the whole batch. Controls: the first
    microbatch's gradients alone, and the sum without the division by n,
    break the gradient bound; the first microbatch's norm breaks the norm
    bound."""
    cfg = get_config(ARCH)
    jparams, params = _same_start()
    model = get_model(cfg)
    rng = np.random.default_rng(1)
    B, S, n = 8, 32, 4
    host = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    _, g1 = step_grads(model, params, batch, COOPT, 1)
    _, gn = step_grads(model, params, batch, COOPT, n)
    _, g_first = loss_and_grads(model, params,
                                {k: v[:B // n] for k, v in batch.items()},
                                COOPT)
    for (path, _), a, b in zip(tree_util.leaves_with_path(params), gn, g1):
        assert _rel_l2(a, b) <= MICRO_GRAD_RTOL, path
    for ctl in (g_first, [g * n for g in gn]):
        assert max(_rel_l2(a, b) for a, b in zip(ctl, g1)) > MICRO_GRAD_RTOL
    p1 = tree_util.tree_map(torch.clone, params)
    p4 = tree_util.tree_map(torch.clone, params)
    p1, _, m1 = make_train_step(cfg, num_microbatches=1)(
        p1, adamw_init(p1), batch)
    p4, _, m4 = make_train_step(cfg, num_microbatches=n)(
        p4, adamw_init(p4), batch)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 5e-3
    gnorm = float(m1["grad_norm"])
    assert float(m4["grad_norm"]) == pytest.approx(gnorm, rel=GNORM_RTOL)
    first = np.sqrt(sum(float(g.float().square().sum()) for g in g_first))
    assert abs(first - gnorm) > GNORM_RTOL * gnorm
    for a, b in zip(tree_util.leaves(p1), tree_util.leaves(p4)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=2e-2, rtol=2e-2)
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    jm = jget_model(jget_config(ARCH))
    jgrads = jax.jit(jax.grad(lambda p: jloss_fn(jm, p, jb, JCOOPT)[0]))(
        jparams)
    for a, b in zip(gn, jax.tree.leaves(jgrads)):
        assert _rel_l2(a, b) <= JAX_GRAD_RTOL
    jp4, _, jm4 = jax.jit(jmake_step(jget_config(ARCH), num_microbatches=n))(
        jparams, jadamw_init(jparams), jb)
    assert abs(float(m4["loss"]) - float(jm4["loss"])) < 5e-3
    assert float(m4["grad_norm"]) == pytest.approx(float(jm4["grad_norm"]),
                                                   rel=GNORM_RTOL)
    for a, b in zip(jax.tree.leaves(jp4), tree_util.leaves(p4)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("arch", ["qwen3-4b-reduced", "rwkv6-7b-reduced"])
def test_loss_decreases(arch):
    cfg = get_config(arch)
    tr = Trainer(cfg, lr=2e-3, device="cpu")
    pipe = TrainPipeline(cfg.vocab_size, batch=4, seq_len=48, seed=0)
    hist = tr.fit(pipe, steps=20, log=None)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_moe_aux_losses_present():
    cfg = get_config("mixtral-8x22b-reduced")
    tr = Trainer(cfg, lr=1e-3, device="cpu")
    pipe = TrainPipeline(cfg.vocab_size, batch=2, seq_len=32, seed=0)
    m = tr.step(next(iter(pipe)))
    assert "load_balance" in m and m["load_balance"] > 0
    assert "router_z" in m and "dropped" in m
    assert m["loss"] >= m["nll"]


# Three Trainer steps against JAX's, measured before the bound was set:
# each leaf's change over the 3 steps (params after less params before)
# within 0.02-0.133 of JAX's as a relative L2 error (embed and the norms
# highest: their changes are a few bf16 ulps); a run on another stream of
# batches lies 0.88-1.49 from it.
TRAINER_DELTA_RTOL = 0.25


def test_trainer_steps_match_jax():
    """Three ``Trainer`` steps from the same weights on the same batches:
    every metric within 1e-2 of the JAX ``Trainer``'s (loss, nll: 1e-2
    absolute; grad norm: 1e-2 relative), every param within 2e-2 (the
    microbatch test's bound: a gradient near zero may turn an Adam step of
    lr the other way), and each leaf's change over the three steps within
    TRAINER_DELTA_RTOL of JAX's (relative L2). Control: a port run on
    another stream of batches breaks the change bound."""
    cfg = get_config(ARCH)
    jtr = JTrainer(jget_config(ARCH), lr=1e-3)
    start = params_from_numpy(cfg, jax.tree.map(np.asarray, jtr.params),
                              "cpu")
    tr = Trainer(cfg, lr=1e-3, device="cpu",
                 params=tree_util.tree_map(torch.clone, start))
    ctl = Trainer(cfg, lr=1e-3, device="cpu",
                  params=tree_util.tree_map(torch.clone, start))
    pipe = TrainPipeline(cfg.vocab_size, batch=4, seq_len=32, seed=0)
    other = TrainPipeline(cfg.vocab_size, batch=4, seq_len=32, seed=1)
    for _ in range(3):
        b = pipe.next_batch()
        mine, theirs = tr.step(b), jtr.step(b)
        ctl.step(other.next_batch())
        assert set(mine) == set(theirs)
        assert abs(mine["loss"] - theirs["loss"]) < 1e-2
        assert abs(mine["nll"] - theirs["nll"]) < 1e-2
        assert mine["grad_norm"] == pytest.approx(theirs["grad_norm"],
                                                  rel=1e-2)
    ctl_rel = []
    for (path, a), b, c, z in zip(
            jax.tree_util.tree_flatten_with_path(jtr.params)[0],
            tree_util.leaves(tr.params), tree_util.leaves(ctl.params),
            tree_util.leaves(start)):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=2e-2,
                                   rtol=2e-2)
        want = np.asarray(a, np.float32) - z.float().numpy()
        assert _rel_l2(b.float() - z.float(), want) <= TRAINER_DELTA_RTOL, \
            jax.tree_util.keystr(path)
        ctl_rel.append(_rel_l2(c.float() - z.float(), want))
    assert max(ctl_rel) > TRAINER_DELTA_RTOL


def test_launcher_trains_and_jax_loads_its_checkpoint(tmp_path, capsys):
    """``launch.train.main`` on the CPU: the reference's log lines, and a
    checkpoint the JAX package loads leaf for leaf (the port's params as
    ``params_to_numpy`` gives them)."""
    params = launch_train.main(["--arch", "qwen3-4b", "--reduced", "--steps",
                                "3", "--batch", "2", "--seq", "32",
                                "--device", "cpu", "--ckpt",
                                str(tmp_path)])
    out = capsys.readouterr().out
    assert "step    0  loss" in out and "step    2  loss" in out
    assert "checkpoint saved to" in out
    like = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    loaded = jload(str(tmp_path), like)
    want = params_to_numpy(get_config(ARCH), params)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_launcher_refuses_tpu_meshes():
    for mesh in ("single", "multi"):
        with pytest.raises(ValueError, match="TPU v5e"):
            launch_train.main(["--arch", "qwen3-4b", "--reduced", "--steps",
                               "1", "--device", "cpu", "--mesh", mesh])


def test_launcher_and_trainer_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(get_config(ARCH))


def test_train_small_example_runs(tmp_path):
    from repro_torch.examples import train_small
    hist = train_small.main(["--steps", "4", "--device", "cpu", "--ckpt",
                             str(tmp_path)])
    assert len(hist) == 4 and hist[-1]["loss"] < hist[0]["loss"]
    assert (tmp_path / "manifest.json").exists()


# ------------------------------------------------------------- guard --
def test_gradient_through_a_kernel_raises_in_both_packages():
    """Under autograd with ``use_kernel=True`` the port's K8 wrapper raises
    (on the CPU too, where it would run its plain version), as
    ``jax.value_and_grad`` raises on the JAX package's ``pallas_call``.
    Under ``torch.no_grad()`` the same forward runs K8's plain version and
    matches the plain path within 0.1 (a few bf16 ulps: K8's blockwise
    online softmax against the full one)."""
    cfg = get_config(ARCH)
    jparams, params = _same_start()
    rng = np.random.default_rng(0)
    host = {k: rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
            for k in ("tokens", "labels")}
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    model = get_model(cfg)
    kern = COOPT.replace(use_kernel=True)
    with pytest.raises(RuntimeError, match="no gradient flows"):
        loss_and_grads(model, params, batch, kern)
    jm = jget_model(jget_config(ARCH))
    jb = {k: jnp.asarray(v) for k, v in host.items()}
    with pytest.raises(AssertionError):    # Pallas has no reverse mode
        jax.value_and_grad(lambda p: jloss_fn(
            jm, p, jb, JCOOPT.replace(use_kernel=True))[0])(jparams)
    with torch.no_grad():
        k_logits, _ = model.forward(params, batch, kern)
        p_logits, _ = model.forward(params, batch, COOPT)
    np.testing.assert_allclose(k_logits.float().numpy(),
                               p_logits.float().numpy(), atol=0.1)
    # serving is untouched: params that need no grad pass the guard
    with torch.enable_grad():
        k2, _ = model.forward(params, batch, kern)
    assert torch.equal(k2, k_logits)
