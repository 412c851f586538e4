"""The port's host side (BlockManager, Scheduler) against the JAX package's:
identical request streams must give identical step plans, page tables,
slots and counters."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.cache.block_manager import BlockManager as JBlockManager  # noqa: E402
from repro.configs.base import CacheConfig as JCacheConfig  # noqa: E402
from repro.serving.request import Request as JRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402

from repro_torch.cache.block_manager import BlockManager  # noqa: E402
from repro_torch.configs.base import CacheConfig  # noqa: E402
from repro_torch.serving.request import Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402


def _stream(seed, n, vocab=64):
    """(prompt, max_new) pairs; half the prompts share a 40-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 40)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(3, 60)))
        prompt = np.concatenate([prefix, tail]) if i % 2 else tail
        out.append((prompt.astype(np.int32), int(rng.integers(2, 12))))
    return out


def test_block_manager_ops_agree():
    """allocate / commit / append / free in lockstep: same pages, slots,
    prefix hits and audit on both."""
    rng = np.random.default_rng(0)
    mine = BlockManager(cfg=CacheConfig(num_pages=24, page_size=8))
    ref = JBlockManager(cfg=JCacheConfig(num_pages=24, page_size=8))
    prompts = [p for p, _ in _stream(1, 10)]
    live = []
    for i, toks in enumerate(prompts):
        if live and rng.random() < 0.4:
            sid = live.pop(int(rng.integers(len(live))))
            mine.free(sid)
            ref.free(sid)
        n = len(toks)
        if not ref.can_allocate(n):
            assert not mine.can_allocate(n)
            continue
        assert mine.allocate(i, n, token_ids=toks) == \
            ref.allocate(i, n, token_ids=toks)
        mine.commit_prefill(i, n, token_ids=toks)
        ref.commit_prefill(i, n, token_ids=toks)
        for _ in range(int(rng.integers(0, 5))):
            assert mine.append_token(i) == ref.append_token(i)
        pos = np.arange(mine.num_tokens(i))
        np.testing.assert_array_equal(mine.slot_indices(i, pos),
                                      ref.slot_indices(i, pos))
        np.testing.assert_array_equal(mine.page_table(i, 12),
                                      ref.page_table(i, 12))
        live.append(i)
    for attr in ("prefix_queries", "prefix_hits", "fresh_pages_allocated",
                 "evictions", "pages_in_use", "free_pages"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert mine.audit() == ref.audit() == []


@pytest.mark.parametrize("num_pages", [0, 12])
def test_scheduler_step_plans_agree(num_pages):
    """Two schedulers fed the same stream, with each step's planned decode
    tokens emitted into both, plan identical steps (``num_pages=12`` forces
    preemption; long prompts are rejected)."""
    kw = dict(num_lanes=3, max_len=96, page_size=8,
              prefill_buckets=[16, 32, 64])
    mine = Scheduler(**kw, cache_cfg=CacheConfig(num_pages=num_pages))
    ref = JScheduler(**kw, cache_cfg=JCacheConfig(num_pages=num_pages))
    mreqs, rreqs = [], []
    for i, (p, mx) in enumerate(_stream(2, 8)):
        mreqs.append(Request(req_id=i, prompt=p, max_new_tokens=mx,
                             arrival_time=float(i)))
        rreqs.append(JRequest(req_id=i, prompt=p.copy(), max_new_tokens=mx,
                              arrival_time=float(i)))
    for a, b in zip(mreqs, rreqs):
        mine.add_request(a)
        ref.add_request(b)
    tok = 0
    for _ in range(200):
        if not ref.has_work:
            break
        pm, pr = mine.schedule_step(), ref.schedule_step()
        got = ([(c.req.req_id, c.start, c.n, c.final, c.first,
                 list(c.tokens)) for c in pm.prefill],
               [(d.req.req_id, d.pos, d.slot) for d in pm.decode])
        want = ([(c.req.req_id, c.start, c.n, c.final, c.first,
                  list(c.tokens)) for c in pr.prefill],
                [(d.req.req_id, d.pos, d.slot) for d in pr.decode])
        assert got == want
        for c, cr in zip(pm.prefill, pr.prefill):
            np.testing.assert_array_equal(mine.page_table(c.req),
                                          ref.page_table(cr.req))
        # host-side emission, identical tokens into both
        for sched, plan in ((mine, pm), (ref, pr)):
            for c in plan.prefill:
                sched.note_prefilled(c.req, c.n)
            emitted = [c.req for c in plan.prefill if c.final] + \
                [d.req for d in plan.decode]
            for r in emitted:
                r.output.append(tok % 64)
            for r in emitted:
                if r.done() and r.lane >= 0:
                    sched.finish(r)
        tok += 1
    assert not ref.has_work and not mine.has_work
    assert mine.preemptions == ref.preemptions
    assert (num_pages == 12) == (ref.preemptions > 0)
    assert len(mine.rejected) == len(ref.rejected) > 0
    assert [r.output for r in mreqs] == [r.output for r in rreqs]
    assert mine.manager.audit() == []
