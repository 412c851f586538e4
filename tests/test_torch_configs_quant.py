"""The port's configs (arch files, the paper's models, the assigned input
shapes), CoOpt modes, FP8 quantizer, Opt-GQA helpers and sampler masks
against the JAX package; qwen2.5-14b-reduced's logits (qkv bias) against
the JAX model."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.cache import quant as jquant  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import paper_models as jpaper  # noqa: E402
from repro.core import coopt as jcoopt  # noqa: E402
from repro.core import opt_gqa as jgqa  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serving import sampler as jsampler  # noqa: E402

from repro_torch.cache import quant  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import ALL_IDS, CacheConfig, get_config  # noqa: E402
from repro_torch.configs import paper_models  # noqa: E402
from repro_torch.configs.base import PORT_ONLY_FIELDS  # noqa: E402
from repro_torch.core import coopt, opt_gqa  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import sampler  # noqa: E402


def _shared_fields(cfg):
    """The port's config on the JAX package's fields, after checking that
    the port's own router fields (``PORT_ONLY_FIELDS``) stand at their
    defaults, the JAX package's routing."""
    fields = dataclasses.asdict(cfg)
    assert {k: fields.pop(k) for k in PORT_ONLY_FIELDS} == PORT_ONLY_FIELDS
    return fields


@pytest.mark.parametrize("arch", [a + s for a in ALL_IDS
                                  for s in ("", "-reduced")])
def test_configs_agree_field_for_field(arch):
    mine, ref = get_config(arch), jget_config(arch)
    assert _shared_fields(mine) == dataclasses.asdict(ref)
    assert mine.q_per_kv == ref.q_per_kv
    assert mine.param_count() == ref.param_count()


@pytest.mark.parametrize("arch", [a + s for a in ALL_IDS
                                  for s in ("", "-reduced")])
def test_active_param_count_agrees(arch):
    """Parameters a token reads (MoE: its top-k routed experts) equal the
    JAX package's count."""
    mine, ref = get_config(arch), jget_config(arch)
    assert mine.active_param_count() == ref.active_param_count()
    assert mine.active_param_count() <= mine.param_count()
    assert (mine.active_param_count() < mine.param_count()) == \
        bool(mine.num_experts)


def test_unported_arch_raises():
    """whisper-small, the last architecture to arrive, equals the JAX
    package's config field for field (full and reduced); an id neither
    package knows raises ``KeyError`` in both."""
    for arch in ("whisper-small", "whisper-small-reduced"):
        mine, ref = get_config(arch), jget_config(arch)
        assert _shared_fields(mine) == dataclasses.asdict(ref)
    assert (mine.encoder_layers, mine.num_frames) == (2, 32)
    for get in (get_config, jget_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("whisper-tiny")


def test_registry_exports_agree():
    """``ARCH_IDS`` is the JAX list, all ten assigned architectures;
    ``ALL_IDS`` adds the paper's model."""
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10 and \
        "whisper-small" in configs.ARCH_IDS
    assert ALL_IDS == jconfigs.ALL_IDS


@pytest.mark.parametrize("name", sorted(jpaper.PAPER_MODELS))
def test_paper_models_agree_field_for_field(name):
    """The paper's five evaluation models and their ``bench_reduced``
    variants equal the JAX package's, field for field, with equal
    parameter counts."""
    mine, ref = paper_models.PAPER_MODELS[name], jpaper.PAPER_MODELS[name]
    assert list(paper_models.PAPER_MODELS) == list(jpaper.PAPER_MODELS)
    assert _shared_fields(mine) == dataclasses.asdict(ref)
    for kw in ({}, dict(layer_div=4, width_div=8, vocab=1024)):
        b, jb = paper_models.bench_reduced(mine, **kw), \
            jpaper.bench_reduced(ref, **kw)
        assert _shared_fields(b) == dataclasses.asdict(jb)
        assert b.param_count() == jb.param_count()
    assert mine.active_param_count() == ref.active_param_count()


def test_input_shapes_agree():
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in configs.SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(jconfigs.get_shape(name))
        assert configs.get_shape(name) is shape
    with pytest.raises(KeyError):
        configs.get_shape("no-such-shape")


def test_qkv_bias_model_logits_match_jax():
    """qwen2.5-14b-reduced (qkv bias, G 2): a full-prompt prefill and a
    decode step on the same weights, with the biases set to seeded random
    values in both (the init makes them zero), give the JAX model's logits
    within tests/test_torch_model.py's LOGIT_ATOL (0.1: bf16 activations
    through 2 layers round differently in the two frameworks)."""
    arch = "qwen2.5-14b-reduced"
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.qkv_bias
    tree = jax.tree.map(np.asarray,
                        jget_model(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    seg = tree["segments"][0]
    for k in ("bq", "bk", "bv"):
        seg[k] = (rng.standard_normal(seg[k].shape) * 0.5).astype(
            seg[k].dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(cfg, tree, "cpu")
    assert params["segments"][0]["bq"].abs().sum() > 0
    mode = coopt.MODES["coopt"].replace(page_size=16)
    jmode = jcoopt.MODES["coopt"].replace(page_size=16)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    cache = model.init_cache(2, 64, mode, device="cpu")
    jcache = jmodel.init_cache(2, 64, jmode)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    for step, batch in (("prefill", {"tokens": toks}),
                        ("decode_step", {"token": nxt})):
        jl, jcache = getattr(jmodel, step)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcache,
            jmode)
        tl, cache = getattr(model, step)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()},
            cache, mode)
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl, np.float32), atol=0.1)
        np.testing.assert_array_equal(cache["length"].numpy(),
                                      np.asarray(jcache["length"]))


def test_cache_config_and_modes_agree():
    from repro.configs.base import CacheConfig as JCacheConfig
    assert dataclasses.asdict(CacheConfig()) == dataclasses.asdict(
        JCacheConfig())
    assert list(coopt.MODES) == list(jcoopt.MODES)
    for name, mode in coopt.MODES.items():
        mine = {k: v for k, v in dataclasses.asdict(mode).items()}
        assert mine == dataclasses.asdict(jcoopt.MODES[name])
    assert coopt.COOPT.use_kernel is False
    assert coopt.COOPT.share_visits is True
    assert coopt.COOPT.kv_dtype == torch.float8_e4m3fn
    assert coopt.ORIGINAL.kv_dtype == torch.bfloat16


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 128)) * rng.uniform(1e-3, 300, (512, 1))
    x = x.astype(np.float32)
    x[0] = 0.0                                   # amax below eps
    # amax 448 gives scale 1: round-to-nearest-even ties and the +-448 edge
    x[1, :10] = [448.0, 1.0625, 1.1875, -1.0625, 432.0, -432.0, 3.25, 208.0,
                 -448.0, 0.0]
    x[1, 10:] = 0.5
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_fp8_bytes_equal(dtype):
    """Pool bytes and scales of ``quantize_fp8`` equal the JAX package's
    exactly (tolerance: none), dequantization too."""
    x = _inputs()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jquant.quantize_fp8(jx)
    tq, ts = quant.quantize_fp8(tx)
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jquant.dequantize_fp8(jq, js, dtype=jnp.float32)
    td = quant.dequantize_fp8(tq, ts, dtype=torch.float32)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert quant.FP8_MAX == jquant.FP8_MAX


def test_opt_gqa_helpers_agree():
    """Eq. 7 group index, fold/unfold and the MHA -> GQA mean pool equal
    the JAX package's (mean pool: exact in f32, bf16 rounding of the same
    f32 mean)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 8, 16)).astype(np.float32)
    tq = torch.from_numpy(q)
    assert torch.equal(opt_gqa.unfold_outputs(opt_gqa.fold_queries(tq, 2)),
                       tq)
    np.testing.assert_array_equal(opt_gqa.fold_queries(tq, 2).numpy(),
                                  np.asarray(jgqa.fold_queries(q, 2)))
    assert [opt_gqa.group_index(i, 8, 2) for i in range(8)] == \
        [int(jgqa.group_index(i, 8, 2)) for i in range(8)]
    w = rng.standard_normal((32, 8 * 16)).astype(np.float32)
    jk, jv = jgqa.mha_to_gqa(jnp.asarray(w, jnp.bfloat16),
                             jnp.asarray(w[::-1].copy(), jnp.bfloat16), 2, 16)
    tk, tv = opt_gqa.mha_to_gqa(torch.from_numpy(w).bfloat16(),
                                torch.from_numpy(w[::-1].copy()).bfloat16(),
                                2, 16)
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))


def test_sampler_masks_and_greedy_agree():
    """top-k / top-p keep-masks (ties broken by rank) and greedy argmax
    equal the JAX sampler's; sampled tokens stay inside the kept set (the
    two packages' PRNGs differ, so draws are not compared)."""
    rng = np.random.default_rng(4)
    lf = np.round(rng.standard_normal((6, 64)), 1).astype(np.float32)  # ties
    tl = torch.from_numpy(lf)
    for k in (1, 5, 17):
        np.testing.assert_array_equal(sampler.top_k_mask(tl, k).numpy(),
                                      np.asarray(jsampler.top_k_mask(lf, k)))
    for p in (0.3, 0.9):
        np.testing.assert_array_equal(sampler.top_p_mask(tl, p).numpy(),
                                      np.asarray(jsampler.top_p_mask(lf, p)))
    np.testing.assert_array_equal(
        sampler.sample(tl).numpy(),
        np.asarray(jsampler.sample(lf, None)))
    gen = torch.Generator().manual_seed(0)
    toks = sampler.sample(tl, gen, temperature=0.8, top_k=5)
    keep = sampler.top_k_mask(tl / 0.8, 5)
    assert toks.dtype == torch.int32
    assert bool(keep[torch.arange(6), toks.long()].all())
