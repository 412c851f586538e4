"""The port's sharded engines on the CPU for the families whose attention
reads the pool: qwen3-4b (dense), deepseek-v2-lite-16b (mla: the latent
kernels) and recurrentgemma-9b (griffin: local attention at head_dim
256 beside the recurrent state), all reduced, on the JAX package's
weights. ``Engine(num_shards=4)`` (shard-affine placement, the kernels over
the whole pool) against the JAX package's ``Engine(num_shards=4)``;
``Engine(mesh=make_sim_mesh(data=4, devices=["cpu"] * 4))`` (each page
range a pool of its own, writes shard-local, each read kernel per shard,
the partials merged) against the port's unsharded engine, with every lane's
page table inside its shard at every step; ``AsyncEngine`` over the mesh
engine against its sync run. Then the mesh engines' pools (one tensor a
shard) and a host-tier spill and upload of a page in shard 2. The kernel wrappers serve CPU tensors with
their plain versions. Greedy streams equal, or part only at a near-tie of
the reference's logits (``test_torch_engine.NEAR_TIE``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.coopt import MODES as JMODES  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.coopt import MODES  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_sim_mesh  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import AsyncEngine, Engine, EngineConfig  # noqa: E402

from test_torch_engine import _assert_same_or_near_tie, _record  # noqa: E402

ARCHS = ["qwen3-4b-reduced", "deepseek-v2-lite-16b-reduced",
         "recurrentgemma-9b-reduced"]
COOPT = MODES["coopt"].replace(use_kernel=True)
CPU4 = ["cpu"] * 4


def _ecfg(cls, **kw):
    return cls(num_lanes=4, max_len=256, prefill_buckets=(32, 64, 128),
               **kw)


def _prompts(cfg):
    """Five prompts; two share a 70-token prefix (a full 64-token page)."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, 70)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)])
            if i < 2 else rng.integers(0, cfg.vocab_size, n)
            for i, n in enumerate((12, 30, 45, 20, 60))]


def _serve_checked(eng, prompts, max_new):
    """``Engine.generate`` with every running request's page table held
    inside its shard's range at every step. Returns the outputs."""
    build = eng._build_step
    seen = []

    def checked(plan, device_feed=False):
        mgr = eng.scheduler.manager
        for r in eng.scheduler.running.values():
            lo, hi = mgr.shard_ranges[r.shard]
            t = np.asarray(eng.scheduler.page_table(r))
            seen.append(bool(np.all((t[t >= 0] >= lo) & (t[t >= 0] < hi))))
        return build(plan, device_feed)
    eng._build_step = checked
    out = eng.generate(prompts, max_new_tokens=max_new)
    eng._build_step = build
    assert seen and all(seen)
    return out


def _partings(got, want):
    """{request: the first token index where ``got`` parts from ``want``}
    (the streams that part)."""
    out = {}
    for rid, seq in want.items():
        mine = [t for t, _ in got[rid]]
        for i, (tok, _) in enumerate(seq):
            if mine[i] != tok:
                out[rid] = i
                break
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engines_match(arch):
    cfg = get_config(arch)
    jparams = jget_model(jget_config(arch)).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    prompts, max_new = _prompts(cfg), 8

    # host shards: the port against the JAX package, both num_shards=4;
    # the port's host shards against its one shard exactly
    jeng = JEngine(jget_config(arch), JMODES["coopt"],
                   _ecfg(JEngineConfig, num_shards=4), params=jparams)
    want = _record(jeng)
    jeng.generate(prompts, max_new_tokens=max_new)
    host = Engine(cfg, COOPT, _ecfg(EngineConfig, num_shards=4),
                  params=params, device="cpu")
    assert host._kernel_ctx is None and host.ccfg.num_shards == 4
    got = _record(host)
    host_out = _serve_checked(host, prompts, max_new)
    assert host.stats.shard_pages == jeng.stats.shard_pages
    assert host.stats.placement_prefix_hits == \
        jeng.stats.placement_prefix_hits
    base = Engine(cfg, COOPT, _ecfg(EngineConfig), params=params,
                  device="cpu")
    ref = _record(base)
    assert base.generate(prompts, max_new_tokens=max_new) == host_out
    if cfg.family != "mla":
        _assert_same_or_near_tie(got, want)
    else:
        # deepseek's reduced streams part from the JAX package's where a
        # MoE router's top-k ties flip (ROADMAP §3), unsharded as well: the
        # shards must move no parting (the JAX engine's own shards change
        # none of its tokens, tests/test_sharded_pool.py)
        jone = JEngine(jget_config(arch), JMODES["coopt"],
                       _ecfg(JEngineConfig), params=jparams)
        want1 = _record(jone)
        jone.generate(prompts, max_new_tokens=max_new)
        assert _partings(got, want) == _partings(ref, want1)

    # the mesh: every read per shard and merged, against the unsharded port
    mesh = Engine(cfg, COOPT, _ecfg(EngineConfig), params=params,
                  device="cpu", mesh=make_sim_mesh(data=4, devices=CPU4))
    assert mesh._kernel_ctx.num_shards == 4 and mesh.ccfg.num_shards == 4
    mine = _record(mesh)
    sync_out = _serve_checked(mesh, prompts, max_new)
    assert all(len(o) == max_new for o in sync_out)
    _assert_same_or_near_tie(mine, ref)
    assert ops.mesh_ctx() is None           # the step scope restored it

    # the async pipeline over the mesh engine: its sync run's tokens
    eng = Engine(cfg, COOPT, _ecfg(EngineConfig), params=params,
                 device="cpu", mesh=make_sim_mesh(data=4, devices=CPU4))
    fe = AsyncEngine(eng, warmup=True)
    hs = [fe.submit(p, max_new_tokens=max_new) for p in prompts]
    fe.run_until_idle()
    fe.close()
    assert [list(h.req.output) for h in hs] == [list(o) for o in sync_out]
    assert eng.aot_misses == 0 and eng.scheduler.manager.audit() == []


def test_rwkv6_accepts_num_shards_for_pool_padding():
    """rwkv6 reads no pool, but its engine takes ``num_shards`` (and a
    mesh): the placement and stats are per shard and its tokens equal the
    unsharded engine's exactly."""
    arch = "rwkv6-7b-reduced"
    cfg = get_config(arch)
    prompts = _prompts(cfg)[:3]
    base = Engine(cfg, COOPT, _ecfg(EngineConfig), device="cpu")
    want = base.generate(prompts, max_new_tokens=4)
    for kw in (dict(engine_cfg=_ecfg(EngineConfig, num_shards=4)),
               dict(engine_cfg=_ecfg(EngineConfig),
                    mesh=make_sim_mesh(data=4, devices=CPU4))):
        eng = Engine(cfg, COOPT, params=base.params, device="cpu", **kw)
        assert eng.stats.num_shards == 1 and eng.ccfg.num_shards == 4
        assert eng.generate(prompts, max_new_tokens=4) == want
        assert eng.stats.num_shards == 4 and len(eng.stats.shard_pages) == 4


@pytest.mark.parametrize("arch", ["qwen3-4b-reduced",
                                  "deepseek-v2-lite-16b-reduced",
                                  "recurrentgemma-9b-reduced",
                                  "whisper-small-reduced"])
def test_mesh_engine_allocates_one_pool_tensor_per_shard(arch):
    """With a mesh every pool leaf (kv and scales; latents and their scales)
    is a ShardedPool of 4 tensors of their own, one a shard on the mesh's
    device, holding exactly its page range: the shapes and bytes add up to
    the unsharded padded pool's, and no two shards share storage. The
    batch-major leaves stay single tensors on the controller. Without a
    mesh (``num_shards`` alone) the pool stays one tensor."""
    from repro_torch.core.opt_kv import ShardedPool
    cfg = get_config(arch)
    eng = Engine(cfg, COOPT, _ecfg(EngineConfig), device="cpu",
                 mesh=make_sim_mesh(data=4, devices=CPU4))
    host = Engine(cfg, COOPT, _ecfg(EngineConfig, num_shards=4),
                  params=eng.params, device="cpu")
    assert eng._kernel_ctx.devices == (torch.device("cpu"),) * 4
    pools = [k for k in eng.cache if k in eng._pool_axis]
    assert "kv" in pools and ("scale" in pools) == COOPT.opt_kv
    for k, leaf in eng.cache.items():
        whole = host.cache[k]
        assert isinstance(whole, torch.Tensor)
        if k not in pools:
            assert isinstance(leaf, torch.Tensor) and leaf.shape == whole.shape
            continue
        ax = eng._pool_axis[k]
        assert isinstance(leaf, ShardedPool) and leaf.num_shards == 4
        assert leaf.pages_dim == ax and leaf.shape == whole.shape
        assert leaf.nbytes == whole.nbytes
        assert len({t.data_ptr() for t in leaf.shards}) == 4
        for t in leaf.shards:
            assert t.device == torch.device("cpu") and t.is_contiguous()
            assert t.shape[ax] == whole.shape[ax] // 4
            assert t.untyped_storage().nbytes() == t.nbytes


def test_host_tier_spill_and_upload_of_a_shard_page_round_trip():
    """The host tier on a 4-shard mesh: a page of shard 2, spilled to the
    host and uploaded into a staging page of shard 0 and of shard 2, lands
    byte for byte (every pool leaf, fp8 and scales), and no other page of
    any shard changes."""
    cfg = get_config("qwen3-4b-reduced")
    from repro_torch.configs import CacheConfig
    eng = Engine(cfg, COOPT, _ecfg(EngineConfig,
                                   cache=CacheConfig(host_pages=8)),
                 device="cpu", mesh=make_sim_mesh(data=4, devices=CPU4))
    gen = torch.Generator().manual_seed(0)
    for k in eng._pool_axis:
        for t in eng.cache[k].shards:
            t.view(torch.uint8).copy_(torch.randint(
                0, 120, t.view(torch.uint8).shape, dtype=torch.uint8,
                generator=gen))
    per = eng.cache["kv"].pages_per_shard
    src = 2 * per + 1
    payload = eng._spill_page(0, src, 2)
    want = {k: eng._pool_page(k, src).clone() for k in eng._pool_axis}

    def snapshot():
        return {k: [t.clone() for t in eng.cache[k].shards]
                for k in eng._pool_axis}
    for dst in (1, 2 * per + 3):
        before = snapshot()
        eng._upload_page(payload, dst)
        for k in eng._pool_axis:
            assert torch.equal(eng._pool_page(k, dst).view(torch.uint8),
                               want[k].view(torch.uint8)), (k, dst)
            s, local = divmod(dst, per)
            for i, (a, b) in enumerate(zip(eng.cache[k].shards, before[k])):
                diff = torch.any((a.view(torch.uint8) != b.view(torch.uint8))
                                 .movedim(eng._pool_axis[k], 0)
                                 .reshape(per, -1), dim=1)
                assert diff.nonzero().flatten().tolist() == \
                    ([local] if i == s else []), (k, dst, i)
