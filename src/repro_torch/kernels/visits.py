"""Cross-lane shared-prefix visit planning for the pooled decode kernel K4.

The refcounted ``BlockManager`` pool stores a prefix shared by N lanes once,
yet a per-lane decode (K2) reads every shared page N times per step. This
module plans the deduplicated *visit list* that lets K4 read it once.

``plan_visits(phys_table, log_table) -> (visit_page, visit_lanes,
visit_log)`` maps the per-lane ``(B, NSel)`` tables onto three flat
``(B * NSel,)`` int32 vectors, one entry per visit:

  * ``visit_page``  — physical page to read, or -1 = skip. One visit per
    distinct live (slot, physical, logical) triple survives; duplicates
    across lanes collapse into their lowest-lane owner.
  * ``visit_lanes`` — int32 bitmask of member lanes (bit b set <=> lane b's
    table holds the same entry), hence B <= 32.
  * ``visit_log``   — logical page id (token positions = log * ps + i).

Visits are slot-major (visit v = s * B + b), so each lane's member visits
come in ascending slot order, the order K2 walks: that is what makes K4
bit-identical to K2. ``plan_visits`` runs on the tables' device;
``sharing_stats`` is the engine's host-side (numpy) count of the same dedup.
"""
from __future__ import annotations

import numpy as np
import torch

# int32 lane bitmask: the visit kernel addresses lanes by bit index.
MAX_VISIT_LANES = 32


def plan_visits(phys_table: torch.Tensor, log_table: torch.Tensor):
    """Plan the deduplicated visit list for one decode step (see module
    docstring). Requires B <= MAX_VISIT_LANES (callers gate this)."""
    B, _ = phys_table.shape
    lane = torch.arange(B, device=phys_table.device)
    live = phys_table >= 0                                     # (B, NSel)
    # same[b, b2, s]: lanes b and b2 hold the identical live entry at slot s
    same = ((phys_table[:, None, :] == phys_table[None, :, :]) &
            (log_table[:, None, :] == log_table[None, :, :]) &
            live[:, None, :] & live[None, :, :])
    # owner = lowest member lane: no earlier lane b2 < b shares the entry
    earlier = same & (lane[None, :, None] < lane[:, None, None])
    is_owner = live & ~earlier.any(dim=1)                      # (B, NSel)
    bits = torch.where(same, (1 << lane)[None, :, None], 0).sum(dim=1)
    bits = ((bits + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)  # int32 wrap
    visit_page = torch.where(is_owner, phys_table, -1)
    visit_lanes = torch.where(is_owner, bits, 0)
    visit_log = torch.where(is_owner, log_table, -1)
    # slot-major flatten: visit v = s * B + b (ascending slots per lane)
    return tuple(x.to(torch.int32).T.contiguous().reshape(-1)
                 for x in (visit_page, visit_lanes, visit_log))


def sharing_stats(page_table: np.ndarray) -> dict:
    """Host-side (numpy) sharing observability for ``EngineStats``.

    page_table: (B, NP) int32 physical page table rows for the lanes of one
    decode step (-1 = pad). Dedup is slot-aligned like ``plan_visits``.
    Returns counts for this step:
      shared_page_visits     — distinct (slot, page) entries held by >1 lane
      dup_page_streams_saved — per-lane page reads the visit list
                               eliminates: sum over shared entries of
                               (members - 1)
      lanes_per_shared_page  — {member-count: number of shared entries}
    """
    stats = {"shared_page_visits": 0, "dup_page_streams_saved": 0,
             "lanes_per_shared_page": {}}
    if page_table.size == 0:
        return stats
    for s in range(page_table.shape[1]):
        col = page_table[:, s]
        _, counts = np.unique(col[col >= 0], return_counts=True)
        for n in counts[counts > 1]:
            n = int(n)
            stats["shared_page_visits"] += 1
            stats["dup_page_streams_saved"] += n - 1
            hist = stats["lanes_per_shared_page"]
            hist[n] = hist.get(n, 0) + 1
    return stats
