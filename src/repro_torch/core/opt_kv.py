"""Opt-KV — KV-cache write/read path (paper §3.1, Alg. 1).

Write phase (Eq. 5): a token's K/V are cached only if its slot index is
valid; slots pre-marked -1 by the caller (padding, prefix-cache hits) are
the SkipSet and never touch memory. The write updates the pool IN PLACE:
unlike the JAX package, which returns a new pool (donated to XLA), the port
mutates the caller's tensor and returns it.

Read phase (Eq. 6): cached K/V are FP8 and dequantized on the fly
(``gather_cached_kv``). The CUDA kernels in ``repro_torch.kernels`` fuse this
into the attention loop; this module is the plain reference path.

Cache layout (one layer) — GLOBAL POOL, no batch dimension:
    kv (2, P_total, ps, Hkv, D) + scale (2, P_total, ps, Hkv).
All sequences share the pool; the host-side ``BlockManager`` hands each
sequence a disjoint set of pages, and each step carries global flat slot
indices and per-lane page tables.

Direct (non-engine) callers get a static lane-identity layout: lane b owns
pages ``[b * P_lane, (b+1) * P_lane)``. The engine's BlockManager never
allocates the pool's final page, whose last line the JAX write kernel uses
as its SkipSet sentinel; the port drops skipped tokens instead of routing
them there.
"""
from __future__ import annotations

import torch

from repro_torch.cache.block_manager import padded_pool_pages
from repro_torch.cache.quant import dequantize_fp8, quantize_fp8
from repro_torch.core.coopt import CoOptConfig


# ------------------------------------------------------- shard ownership --
# The mesh axes the pool's pages axis is split over (the port's
# ``launch.mesh`` meshes carry them by name): ``launch.mesh.kv_shard_count``
# takes its extent from them, ``BlockManager.shard_page_ranges`` is the
# host's copy of the split, and ``kernels.sharded`` runs each kernel once
# per page range, on the shard's own pool (``ShardedPool``).
PAGES_AXES = ("pod", "data")


def pool_layout(batch: int, max_len: int, coopt, num_shards: int = 1,
                cache_cfg=None):
    """The device pool's pages-axis layout -> ``(P, page_size)``: the
    requested pool size (``CacheConfig.num_pages`` when set, else ``batch *
    pages(max_len)``) padded so the pages axis splits evenly into the KV
    shards (``CacheConfig.num_shards`` when a config is given). Every
    model's ``cache_shape`` and the scheduler's BlockManager agree on this
    rule, so host page ids are device page ids; the final padded page is
    the reserved one."""
    ps = coopt.page_size
    pages = 0
    if cache_cfg is not None:
        ps = cache_cfg.page_size or ps
        num_shards = cache_cfg.num_shards or num_shards
        pages = cache_cfg.num_pages
    if not pages:
        pages = batch * (-(-max_len // ps))
    return padded_pool_pages(pages, num_shards), ps


def global_to_local_pages(phys_table: torch.Tensor, first_page: int,
                          num_local: int) -> torch.Tensor:
    """A GLOBAL physical page table in one shard's LOCAL page domain:
    entries inside ``[first_page, first_page + num_local)`` become local
    indices, every other entry (another shard's page, or a -1 hole) -1, the
    kernels' hole, never read. int32, on the table's device."""
    local = phys_table - first_page
    owned = (phys_table >= 0) & (local >= 0) & (local < num_local)
    return torch.where(owned, local, -1).to(torch.int32)


def global_to_local_slots(slot_idx: torch.Tensor, first_slot: int,
                          num_local: int) -> torch.Tensor:
    """The flat-slot form of ``global_to_local_pages``: GLOBAL flat slots
    (page * ps + offset) inside ``[first_slot, first_slot + num_local)``
    become local slots; every other slot (another shard's, or a negative
    SkipSet slot) becomes ``num_local``, one PAST the shard's last line, so
    a scatter that drops out-of-range slots discards it. Never -1, which
    would wrap onto the shard's last line: live data on every shard but the
    last. int32, on the slots' device."""
    local = slot_idx - first_slot
    owned = (slot_idx >= 0) & (local >= 0) & (local < num_local)
    return torch.where(owned, local, num_local).to(torch.int32)


# ------------------------------------------------------- sharded pools --
class ShardedPool:
    """One pool leaf as page-range shards, each a tensor of its own (on its
    mesh device): shard s holds the global pages ``[s * per, (s + 1) *
    per)`` along axis ``pages_dim``. The models hand it to the kernel
    wrappers unchanged (``kernels.sharded`` reads and writes each shard on
    its device); indexing a leading axis (a layer) indexes every shard, and
    ``shape`` is the whole pool's."""
    __slots__ = ("shards", "pages_dim")

    def __init__(self, shards, pages_dim: int):
        self.shards = tuple(shards)
        self.pages_dim = pages_dim

    @classmethod
    def split(cls, pool: torch.Tensor, devices, pages_dim: int):
        """A copy of ``pool`` as ``len(devices)`` shards, shard s a new
        tensor on ``devices[s]`` (built from an existing pool; the engine
        allocates its shards directly, ``alloc_cache``)."""
        n = len(devices)
        if pool.shape[pages_dim] % n:
            raise ValueError(f"{pool.shape[pages_dim]} pages do not split "
                             f"into {n} equal shards")
        return cls([c.to(d, memory_format=torch.contiguous_format,
                         copy=True)
                    for c, d in zip(pool.chunk(n, pages_dim), devices)],
                   pages_dim)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def pages_per_shard(self) -> int:
        return self.shards[0].shape[self.pages_dim]

    @property
    def shape(self) -> torch.Size:
        sh = list(self.shards[0].shape)
        sh[self.pages_dim] *= len(self.shards)
        return torch.Size(sh)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def requires_grad(self) -> bool:
        return any(s.requires_grad for s in self.shards)

    @property
    def nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)

    def __getitem__(self, i: int) -> "ShardedPool":
        if self.pages_dim == 0:
            raise IndexError("a ShardedPool indexes its leading axes only; "
                             "address a page with page()")
        return ShardedPool([s[i] for s in self.shards], self.pages_dim - 1)

    def page(self, page: int) -> torch.Tensor:
        """Global page ``page``: a view into the shard that holds it."""
        s, local = divmod(int(page), self.pages_per_shard)
        return self.shards[s].select(self.pages_dim, local)


def alloc_cache(shapes, device, shard_devices=None):
    """Zero leaves for a model's ``cache_shape``. With ``shard_devices``
    (one device a page-range shard, in shard order) every leaf with a
    ``pages`` axis is a ``ShardedPool`` of one zero tensor a shard, each
    on its device and holding its page range; no whole pool is
    allocated. The batch-major leaves stay on ``device``."""
    out = {}
    for k, (sh, dt, axes) in shapes.items():
        if shard_devices and "pages" in axes:
            ax, n = axes.index("pages"), len(shard_devices)
            if sh[ax] % n:
                raise ValueError(f"{sh[ax]} pages do not split into {n} "
                                 "equal shards (core.opt_kv.pool_layout "
                                 "pads them)")
            part = sh[:ax] + (sh[ax] // n,) + sh[ax + 1:]
            out[k] = ShardedPool([torch.zeros(part, dtype=dt, device=d)
                                  for d in shard_devices], ax)
        else:
            out[k] = torch.zeros(sh, dtype=dt, device=device)
    return out


# ------------------------------------------------------- identity layout --
def pages_per_lane(total_pages: int, batch: int) -> int:
    return max(total_pages // batch, 1)


def identity_page_table(batch: int, total_pages: int,
                        device="cpu") -> torch.Tensor:
    """Static lane-partitioned page table (B, P_lane): lane b owns the
    contiguous page range [b*P_lane, (b+1)*P_lane)."""
    P_lane = pages_per_lane(total_pages, batch)
    return (torch.arange(batch, dtype=torch.int32, device=device)[:, None]
            * P_lane
            + torch.arange(P_lane, dtype=torch.int32, device=device)[None, :])


def identity_slots(batch: int, positions: torch.Tensor, total_pages: int,
                   page_size: int) -> torch.Tensor:
    """Logical positions (B, S) -> global flat slots under the lane-identity
    layout (slot == lane_offset + position)."""
    P_lane = pages_per_lane(total_pages, batch)
    off = (torch.arange(batch, dtype=torch.int32, device=positions.device)
           [:, None] * (P_lane * page_size))
    return positions.to(torch.int32) + off


def write_kv(kv_cache, scale_cache, k_new, v_new, slot_idx,
             coopt: CoOptConfig):
    """Write new tokens' K/V into the global paged cache, in place.

    kv_cache: (2, P, ps, Hkv, D); k_new/v_new: (B, S, Hkv, D);
    slot_idx: (B, S) int32 GLOBAL flat slot; negative = SkipSet (dropped).
    Returns (kv_cache, scale_cache), the same tensors, updated."""
    if coopt.use_kernel:
        from repro_torch.kernels import ops
        return ops.kv_cache_write(kv_cache, scale_cache, k_new, v_new,
                                  slot_idx, opt_kv=coopt.opt_kv)
    _, P, ps, H, D = kv_cache.shape
    flat = kv_cache.view(2, P * ps, H, D)
    slots = slot_idx.reshape(-1).long()
    keep = (slots >= 0) & (slots < P * ps)
    slots = slots[keep]
    new = torch.stack([k_new, v_new]).reshape(2, -1, H, D)[:, keep]
    if coopt.opt_kv:
        q, s = quantize_fp8(new, dim=-1)
        flat[:, slots] = q
        scale_cache.view(2, P * ps, H)[:, slots] = s
    else:
        flat[:, slots] = new.to(flat.dtype)
    return kv_cache, scale_cache


def dequant_pages(kv_pages, scale_pages, coopt: CoOptConfig,
                  dtype=torch.bfloat16):
    """Eq. 6 read path: fp8 pages -> compute dtype."""
    if coopt.opt_kv:
        return dequantize_fp8(kv_pages, scale_pages, dim=-1, dtype=dtype)
    return kv_pages.to(dtype)


def gather_cached_kv(kv_cache, scale_cache, page_table, coopt: CoOptConfig,
                     dtype=torch.bfloat16):
    """Reference of the paper's ``gather_cached_kv`` kernel.

    kv_cache: (2, P, ps, Hkv, D) global pool; page_table: (B, Psel) int32
    physical page ids in logical order (negative => zero page). Returns
    (2, B, Psel*ps, Hkv, D) dequantized: token j of the output is the
    lane's logical position j."""
    _, P, ps, H, D = kv_cache.shape
    B, Psel = page_table.shape
    pt = page_table.clamp_min(0).long()
    gathered = kv_cache[:, pt]                             # (2,B,Psel,ps,H,D)
    if coopt.opt_kv:
        out = dequantize_fp8(gathered, scale_cache[:, pt], dim=-1,
                             dtype=dtype)
    else:
        out = gathered.to(dtype)
    valid = (page_table >= 0)[None, :, :, None, None, None]
    out = torch.where(valid, out, torch.zeros((), dtype=dtype,
                                              device=out.device))
    return out.reshape(2, B, Psel * ps, H, D)


def window_page_table(cache_len: torch.Tensor, num_pages: int,
                      page_size: int, window: int, sink_pages: int):
    """Opt-KV SkipSet as block sparsity, in the LOGICAL page domain: sink
    pages [0, sink) plus the trailing ``window // ps + 1`` pages covering the
    sliding window, for ``cache_len`` (B,) inclusive token counts. Returns
    (B, Psel) logical page ids, -1 = skipped; a logical id beyond the lane's
    table width is a skip, never an alias."""
    dev = cache_len.device
    wpages = window // page_size + 1
    last_page = (cache_len.long() - 1).clamp_min(0) // page_size   # (B,)
    start = (last_page - (wpages - 1)).clamp_min(0)
    win = start[:, None] + torch.arange(wpages, device=dev)[None, :]
    win = torch.where(win <= last_page[:, None], win, -1)
    sink = torch.arange(sink_pages, device=dev)[None, :] \
        .expand(win.shape[0], sink_pages)
    sink = torch.where(sink < start.clamp_max(sink_pages)[:, None], sink, -1)
    table = torch.cat([sink, win], dim=1)
    return torch.where(table >= num_pages, -1, table).to(torch.int32)


def logical_to_physical(logical_table, page_table):
    """Map a (B, NSel) LOGICAL page selection (-1 = skipped) through the
    per-lane (B, P_lane) physical page table, preserving -1 sentinels."""
    phys = torch.gather(page_table, 1, logical_table.clamp_min(0).long())
    return torch.where(logical_table < 0, -1, phys).to(torch.int32)


def decode_page_select(cache_len, page_table, page_size: int, *,
                       window: int = 0, sink_pages: int = 1,
                       opt_pa: bool = True):
    """(physical, logical) page selection for ONE decode step against the
    pool. Dense (``window == 0``): logical pages are ``arange``; under
    Opt-Pa, physical entries wholly beyond the live context become -1
    (Eq. 9 valid-block filtering), while the Original baseline streams every
    allocated page. Windowed: the {sink + window} policy is decided in the
    logical page domain and mapped through the lane's table."""
    B, P = page_table.shape
    if window:
        logical = window_page_table(cache_len, P, page_size, window,
                                    sink_pages)
        return logical_to_physical(logical, page_table), logical
    logical = torch.arange(P, dtype=torch.int32,
                           device=page_table.device)[None].expand(B, P)
    if opt_pa:
        beyond = logical * page_size >= cache_len[:, None]
        phys = torch.where(beyond, -1, page_table)
    else:
        phys = page_table
    return phys.to(torch.int32).contiguous(), logical.contiguous()
