"""The port's ``launch/steps.py`` and ``launch/dryrun.py``: the twins of
``tests/test_sharding.py``'s policy and bundle cells and of
``tests/test_microbatch.py``'s microbatch policy; ``make_step``'s decode,
prefill and train steps on the CPU against the JAX package's model steps
from the same weights and inputs; the dry run's exact argument bytes, its
FLOPs against a closed form and against ``FlopCounterMode``, and its
record. Reduced configs; a dry run on the meta device at the real shapes.
(``inspect_cell`` needs the card: ``tests/test_torch_cuda.py``.)"""
import json

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.shapes import InputShape as JInputShape  # noqa: E402
from repro.core.coopt import COOPT as JCOOPT  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.training import adamw_init as jadamw_init  # noqa: E402
from repro.training.train import make_train_step as jmake_step  # noqa: E402

from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.checkpoint.ckpt import host_array  # noqa: E402
from repro_torch.configs import (ALL_IDS, ARCH_IDS, SHAPES,  # noqa: E402
                                 InputShape, get_config)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import (LONG_WINDOW, ShapeSkipped,  # noqa: E402
                                      Spec, StepBundle,
                                      default_microbatches,
                                      effective_config, long_window_for,
                                      make_step, tree_nbytes)
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "qwen3-4b-reduced"
# the port against the JAX model on the same weights and inputs, 2 layers
# with an fp8 cache: the bound of tests/test_torch_model.py for
# qwen3-4b-reduced logits (measured there at most 0.066); greedy tokens
# equal unless the JAX logits' best two lie within NEAR_TIE
LOGIT_ATOL = 0.1
NEAR_TIE = 0.1


@pytest.fixture(scope="module")
def weights():
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(
        get_config(ARCH), jax.tree.map(np.asarray, jparams), "cpu")


def _jshape(s):
    return JInputShape(s.name, s.seq_len, s.global_batch, s.kind)


def _np(t):
    """A tensor as numpy, fp8 as ml_dtypes' float8_e4m3fn (its bytes)."""
    a, name = host_array(t)
    return a.view(getattr(ml_dtypes, name)) if a.dtype == np.uint8 and \
        name.startswith("float8") else a


# ------------------------------------------------------------- policies --
def test_long500k_policy():
    for arch, expect_window in [("qwen3-4b", True), ("deepseek-67b", True),
                                ("mixtral-8x22b", False),
                                ("rwkv6-7b", False),
                                ("recurrentgemma-9b", False)]:
        lw = long_window_for(get_config(arch), SHAPES["long_500k"])
        assert (lw > 0) == expect_window, arch
    # and every (arch x shape) cell's window is the JAX package's
    for arch in ALL_IDS:
        for name, s in SHAPES.items():
            cfg = get_config(arch)
            if arch == "whisper-small" and name == "long_500k":
                continue
            assert long_window_for(cfg, s) == jsteps.long_window_for(
                jget_config(arch), _jshape(s)), (arch, name)
    assert LONG_WINDOW == jsteps.LONG_WINDOW


def test_whisper_long500k_skipped():
    with pytest.raises(ShapeSkipped):
        effective_config(get_config("whisper-small"), SHAPES["long_500k"])
    with pytest.raises(ShapeSkipped):
        make_step("whisper-small", "long_500k", device="meta")
    assert dryrun.run_one("whisper-small", "long_500k",
                          verbose=False)["status"] == "skipped"


def test_default_microbatches_policy():
    assert default_microbatches(get_config("mixtral-8x22b")) == 8    # MoE
    assert default_microbatches(get_config("deepseek-67b")) == 16    # 67B
    assert default_microbatches(get_config("qwen2.5-14b")) == 4
    assert default_microbatches(get_config("rwkv6-7b")) == 2
    assert default_microbatches(get_config("qwen3-4b")) == 1
    assert default_microbatches(get_config("recurrentgemma-9b")) == 8
    assert default_microbatches(get_config("internvl2-2b")) == 1
    for arch in ALL_IDS:
        assert default_microbatches(get_config(arch)) == \
            jsteps.default_microbatches(jget_config(arch)), arch


def test_all_arch_shape_bundles_build():
    """make_step builds every live (arch x shape) cell on the meta device
    without running it: 39 built, whisper x long_500k skipped; each
    bundle's input specs are the JAX bundle's inputs in shape (the port's
    layouts are the reference's) and become meta tensors."""
    built, skipped = 0, 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            try:
                b = make_step(arch, shape, device="meta")
            except ShapeSkipped:
                skipped += 1
                continue
            assert isinstance(b, StepBundle) and b.kind == \
                SHAPES[shape].kind and len(b.args) == 3
            leaves = tree_util.leaves(b.args)
            assert leaves and all(isinstance(s, Spec) for s in leaves)
            metas = tree_util.leaves(b.meta_args())
            assert all(t.is_meta for t in metas)
            assert [tuple(t.shape) for t in metas] == [s.shape
                                                      for s in leaves]
            built += 1
    assert built == 39 and skipped == 1


def test_bundle_specs_match_jax_model():
    """The decode cell's batch and cache specs are the JAX model's
    ``input_specs`` and ``cache_shape``, shape and dtype name, leaf by
    leaf (params: ``test_torch_model``'s conversion checks each leaf)."""
    b = make_step("qwen3-4b", "long_500k", device="meta")
    jm = jget_model(jget_config("qwen3-4b"))
    s = SHAPES["long_500k"]
    want = jm.input_specs(_jshape(s))
    got = b.args[1]
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape)
    jc = jm.cache_shape(s.global_batch, s.seq_len, JCOOPT)
    assert set(b.args[2]) == set(jc)
    for k, (sh, dt, _) in jc.items():
        assert b.args[2][k].shape == tuple(sh), k
        assert str(b.args[2][k].dtype).removeprefix("torch.") == \
            np.dtype(dt).name, k


# ------------------------------------------------------------ the steps --
def _greedy_ok(got, want):
    """Greedy tokens equal, or parted at a near-tie of ``want``."""
    g, w = got.argmax(-1), want.argmax(-1)
    for i in np.flatnonzero(g != w):
        top2 = np.sort(want[i])[-2:]
        assert top2[1] - top2[0] < NEAR_TIE, i


@pytest.mark.parametrize("shape", [
    InputShape("decode_32k", 256, 2, "decode"),
    InputShape("long_500k", 1024, 1, "decode")], ids=lambda s: s.name)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_step_matches_jax(weights, shape, use_kernel):
    """make_step's decode step (a cache of ``seq_len - 1`` random tokens
    from ``init_args``; long_500k decodes through the LONG_WINDOW policy)
    against the JAX model's ``decode_step`` with the JAX policy's window on
    the same weights, token and cache bytes: logits within LOGIT_ATOL,
    greedy tokens equal or parted at a near-tie; both write the token at
    the same slot and count it."""
    jparams, params = weights
    coopt = JCOOPT
    b = make_step(ARCH, shape, coopt=_port_coopt(use_kernel), device="cpu")
    _, batch, cache = b.init_args(seed=3)
    assert int(cache["length"][0]) == shape.seq_len - 1
    lw = jsteps.long_window_for(jget_config(ARCH), _jshape(shape))
    assert b.long_window == lw
    jcache = {k: jnp.asarray(_np(v)) for k, v in cache.items()}
    jbatch = {k: jnp.asarray(_np(v)) for k, v in batch.items()}
    with torch.no_grad():
        logits, out = b.fn(params, batch, cache)
    jlogits, jout = jget_model(jget_config(ARCH)).decode_step(
        jparams, jbatch, jcache, coopt, long_window=lw)
    want = np.asarray(jlogits, np.float32)
    got = logits.float().numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
    _greedy_ok(got, want)
    np.testing.assert_array_equal(out["length"].numpy(),
                                  np.asarray(jout["length"]))


def _port_coopt(use_kernel):
    from repro_torch.core.coopt import COOPT
    return COOPT.replace(use_kernel=use_kernel)


def test_prefill_step_matches_jax(weights):
    """make_step's prefill step (a full prompt into an empty cache) against
    the JAX model's ``prefill`` on the same weights and tokens: last-token
    logits within LOGIT_ATOL, greedy tokens equal or parted at a
    near-tie, the cache lengths alike."""
    jparams, params = weights
    shape = InputShape("prefill_32k", 96, 2, "prefill")
    b = make_step(ARCH, shape, device="cpu")
    _, batch, cache = b.init_args(seed=4)
    jcache = {k: jnp.asarray(_np(v)) for k, v in cache.items()}
    with torch.no_grad():
        logits, out = b.fn(params, batch, cache)
    jlogits, jout = jget_model(jget_config(ARCH)).prefill(
        jparams, {k: jnp.asarray(_np(v)) for k, v in batch.items()}, jcache,
        JCOOPT)
    want = np.asarray(jlogits, np.float32)
    got = logits.float().numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL)
    _greedy_ok(got, want)
    np.testing.assert_array_equal(out["length"].numpy(),
                                  np.asarray(jout["length"]))


def test_train_step_matches_jax(weights):
    """make_step's train step (the policy's one microbatch at
    qwen3-4b-reduced) against the JAX ``make_train_step`` from the same
    weights and batch: loss within 5e-3, grad norm within 1e-2 relative,
    every param after the step within 2e-2 (``test_torch_train_launch``'s
    bounds); the AdamW step count 1."""
    jparams, params = weights
    shape = InputShape("train_4k", 32, 4, "train")
    b = make_step(ARCH, shape, device="cpu")
    _, opt, batch = b.init_args(seed=5)
    p = tree_util.tree_map(torch.clone, params)
    p, opt, m = b.fn(p, _fresh_opt(p), batch)
    jb = {k: jnp.asarray(_np(v)) for k, v in batch.items()}
    jp, jopt, jm = jax.jit(jmake_step(
        jget_config(ARCH), num_microbatches=jsteps.default_microbatches(
            jget_config(ARCH))))(jparams, jadamw_init(jparams), jb)
    assert int(opt.step) == 1 == int(jopt.step)
    assert abs(float(m["loss"]) - float(jm["loss"])) < 5e-3
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-2)
    for a, c in zip(jax.tree.leaves(jp), tree_util.leaves(p)):
        np.testing.assert_allclose(c.float().numpy(),
                                   np.asarray(a, np.float32), atol=2e-2,
                                   rtol=2e-2)


def _fresh_opt(params):
    from repro_torch.training.optimizer import adamw_init
    return adamw_init(params)


# -------------------------------------------------------------- dry run --
@pytest.mark.parametrize("arch,shape", [
    (ARCH, InputShape("decode_32k", 256, 2, "decode")),
    ("deepseek-v2-lite-16b-reduced", InputShape("train_4k", 16, 8,
                                                "train"))],
    ids=["qwen3-decode", "deepseek-train"])
def test_dryrun_argument_bytes_exact(arch, shape):
    """The dry run's ``argument_bytes`` is the sum of the real inputs'
    bytes (``init_args`` on the CPU: params, AdamW moments and step for
    train, cache and batch), computed on meta tensors."""
    rec = dryrun.run_one(arch, shape, verbose=False)
    b = make_step(arch, shape, device="cpu")
    real = sum(t.nbytes for t in tree_util.leaves(b.init_args(0)))
    assert rec["status"] == "ok" and rec["path"] == "plain"
    assert rec["memory"]["argument_bytes"] == real
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["collective_bytes"] == 0


def test_dryrun_decode_flops_closed_form():
    """qwen3-4b-reduced x decode_32k on meta: the step's FLOPs equal its
    matmuls counted by hand: per layer the q, k, v and o projections, the
    SwiGLU FFN, and the plain Opt-Pa attention (scores and weighted values
    over each lane's 512 pages of 64 tokens), then the LM head."""
    cfg = get_config(ARCH)
    s = SHAPES["decode_32k"]
    B, d, H, Hkv, D = (s.global_batch, cfg.d_model, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    pages = s.seq_len // 64
    per_layer = (2 * B * d * H * D + 2 * 2 * B * d * Hkv * D
                 + 2 * B * H * D * d + 3 * 2 * B * d * cfg.d_ff
                 + 2 * 2 * B * H * pages * 64 * D)
    want = cfg.num_layers * per_layer + 2 * B * d * cfg.vocab_size
    rec = dryrun.run_one(ARCH, "decode_32k", verbose=False)
    assert rec["cost"]["flops"] == want


@pytest.mark.parametrize("S,B", [(16384, 1), (32768, 2)])
def test_dryrun_decode_bytes_closed_form(S, B):
    """qwen3-4b-reduced decoding through the long_500k window on meta: the
    bytes the step must move (``min_bytes``, the roofline's M) equal a
    count by hand: every weight (of the embedding only the B rows looked
    up), per layer the K and V pages of the window (the sink page, 128
    window pages, the current page) with their f32 scales and the one
    written row of each, the token and cache length, and the logits and
    new length returned. The plain path's per-op ``bytes accessed`` grows
    with a 4x larger pool only by the lane tables' index arithmetic (an
    arange written, 4 B a table entry, then read by an add that writes
    4 B an entry and lane): no op reads the whole pool."""
    cfg = get_config(ARCH)
    shape = InputShape("long_500k", S, B, "decode")
    rec = dryrun.run_one(ARCH, shape, verbose=False)
    step = make_step(ARCH, shape, device="meta")
    params, ps = step.args[0], step.coopt.page_size
    d, Hkv, D, V = cfg.d_model, cfg.num_kv_heads, cfg.head_dim, cfg.vocab_size
    pages = 1 + LONG_WINDOW // ps + 1
    weights = tree_nbytes(params) - params["embed"].nbytes + B * d * 2
    per_layer = (2 * B * pages * ps * Hkv * (D + 4)      # pages + scales
                 + 2 * B * Hkv * (D + 4))                # the written row
    outputs = B * V * 2 + B * 4
    assert rec["memory"]["output_bytes"] == outputs
    assert rec["cost"]["min_bytes"] == (weights + cfg.num_layers * per_layer
                                        + 2 * B * 4 + outputs)
    big = dryrun.run_one(ARCH, InputShape("long_500k", 4 * S, B, "decode"),
                         verbose=False)
    assert big["cost"]["min_bytes"] == rec["cost"]["min_bytes"]
    assert big["cost"]["bytes accessed"] - rec["cost"]["bytes accessed"] \
        == (8 + 4 * B) * 3 * (S // ps)
    assert rec["cost"]["bytes accessed"] > rec["cost"]["min_bytes"]


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-v2-lite-16b-reduced", InputShape("train_4k", 16, 8,
                                                "train")),
    ("mixtral-8x22b-reduced", InputShape("train_4k", 32, 8, "train"))],
    ids=["deepseek-train", "mixtral-train"])
def test_dryrun_microbatch_extension_exact(arch, shape):
    """A train step of 8 microbatches counted at 2 and 3 and extended to 8
    gives the record of the run of all 8: FLOPs, bytes accessed, bytes to
    move, output and peak temp bytes."""
    got = dryrun.run_one(arch, shape, verbose=False)
    whole = dryrun.run_one(arch, shape, verbose=False, whole=True)
    assert got["microbatches"] == 8 > dryrun.EXTEND_MICROBATCHES
    assert got["microbatches_counted"] == [2, 3]
    assert "microbatches_counted" not in whole
    assert (got["cost"], got["memory"]) == (whole["cost"], whole["memory"])


@pytest.mark.parametrize("arch,shape", [
    (ARCH, InputShape("prefill_32k", 256, 2, "prefill")),
    ("mixtral-8x22b-reduced", InputShape("train_4k", 32, 8, "train")),
    ("rwkv6-7b-reduced", InputShape("prefill_32k", 96, 1, "prefill"))],
    ids=["qwen3-prefill", "mixtral-train", "rwkv6-prefill"])
def test_dryrun_flops_equal_flop_counter_mode(arch, shape):
    """The dry run counts each op once per signature with
    ``FlopCounterMode``'s formulas; the whole step under
    ``FlopCounterMode`` itself counts the same."""
    from torch.utils.flop_counter import FlopCounterMode
    rec = dryrun.run_one(arch, shape, verbose=False)
    b = make_step(arch, shape, device="meta")
    with dryrun._nonzero_assumed(), FlopCounterMode(display=False) as fc:
        b.fn(*b.meta_args())
    assert rec["cost"]["flops"] == fc.get_total_flops() > 0


@pytest.mark.parametrize("arch,shape", [
    (ARCH, InputShape("decode_32k", 512, 4, "decode")),
    ("deepseek-v2-lite-16b-reduced", InputShape("prefill_32k", 128, 2,
                                                "prefill")),
    ("whisper-small-reduced", InputShape("train_4k", 32, 2, "train"))],
    ids=["qwen3-decode", "deepseek-prefill", "whisper-train"])
def test_dryrun_memo_changes_no_count(arch, shape):
    """``MetaStep`` runs a pure op once per signature; running every op
    gives the same FLOPs, bytes accessed, bytes to move and peak temp
    bytes."""
    b = make_step(arch, shape, device="meta")
    got = []
    for memo in (True, False):
        args = b.meta_args()
        t = dryrun.MetaStep(tree_util.leaves(args), memo=memo)
        with dryrun._nonzero_assumed(), t:
            b.fn(*args)
        got.append((t.flops, t.bytes_accessed, t.min_bytes, t.peak))
    assert got[0] == got[1] and got[0][3] > 0


def test_dryrun_cli_writes_records(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch A --shape S --out F``
    appends one JSON record with the reference's keys."""
    out = tmp_path / "dry.jsonl"
    assert dryrun.main(["--arch", "rwkv6-7b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes"}
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["fits_h100_80gib"] is True
    assert "1 ok (1 fit one H100)" in capsys.readouterr().out
