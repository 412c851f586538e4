"""Deterministic fault injection for the port's serving stack, the
counterpart of the JAX package's ``serving/faults.py``.

A seeded ``FaultPlan`` names WHERE and WHEN faults fire; ``FaultInjector``
installs the plan onto a live ``Engine`` (``engine.faults``) and the
serving code calls back into it at these hook points:

  * ``append_token`` (wrapped at install time) — raise ``OutOfBlocks`` on
    a chosen call index, for a chosen run length: a pool-pressure STORM
    that drives the scheduler's preemption/requeue machinery without
    needing a genuinely full pool;
  * ``before_execute`` (sync ``Engine._execute`` and async
    ``Engine._dispatch_async``) — raise ``FaultInjected`` at a chosen
    step: the dispatched-step fault the frontend must drain as ERROR;
  * ``on_emit`` (``AsyncEngine._emit_worker``) — delay every host sync,
    or raise ``WorkerKilled`` at a chosen emission so the worker dies
    SILENTLY and only the stall watchdog can notice;
  * ``on_turn`` (top of ``AsyncEngine._loop_once``) — seeded cancel
    storms: at chosen turns, cancel a deterministic fraction of the open
    streams;
  * ``on_spill`` (``Engine._spill_page``) / ``on_prefetch``
    (``Engine._start_prefetch``) — the host-DRAM tier's hooks: drop chosen
    device->host spills, fail chosen host->device prefetches or stretch
    their landing.

Everything is keyed to deterministic counters (append calls, dispatched
steps, emissions, loop turns) and a seeded RNG — the same plan against the
same workload replays the same episode, so the chaos suite can assert
exact terminal statuses and bit-identical survivor outputs."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.cache.block_manager import OutOfBlocks
from repro_torch.serving.frontend import WorkerKilled


class FaultInjected(RuntimeError):
    """The step fault ``FaultPlan.raise_at_step`` injects."""


@dataclass(frozen=True)
class FaultPlan:
    """One chaos episode's fault schedule (all counters 1-based; None or
    () disables a fault)."""
    seed: int = 0
    oob_at_append: Optional[int] = None   # Nth append_token call raises
    oob_count: int = 1                    # ..and this many in a row
    raise_at_step: Optional[int] = None   # Nth dispatched step raises
                                          # FaultInjected before execution
    emit_delay_s: float = 0.0             # slow every emit-worker host sync
    kill_emit_at: Optional[int] = None    # Nth emission kills the worker
                                          # silently (WorkerKilled)
    cancel_at_turns: Tuple[int, ...] = () # loop turns firing a cancel storm
    cancel_frac: float = 0.5              # fraction of open streams per storm
    # ------------------------------------------------ host-DRAM KV tier --
    spill_drop_at: Optional[int] = None   # Nth spill is dropped (page dies
                                          # DROPPED instead of landing HOST)
    spill_drop_count: int = 1             # ..and this many in a row
    prefetch_fail_at: Optional[int] = None  # Nth prefetch aborts at landing
    prefetch_fail_count: int = 1            # ..and this many in a row
    prefetch_delay_turns: int = 0         # extra scheduler turns every
                                          # prefetch takes to land (slow
                                          # host link)


class FaultInjector:
    """Live counters + hook callbacks for one ``FaultPlan`` episode."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.appends = 0        # append_token calls seen
        self.steps = 0          # device steps dispatched
        self.emissions = 0      # emit-worker items processed
        self.turns = 0          # frontend loop turns
        self.injected_oob = 0
        self.injected_cancels = 0
        self.spills = 0         # spill attempts seen
        self.prefetches = 0     # prefetch uploads started
        self.injected_spill_drops = 0
        self.injected_prefetch_fails = 0

    # ---------------------------------------------------------- install --
    def install(self, engine) -> "FaultInjector":
        """Attach to ``engine``: set ``engine.faults`` and wrap the block
        manager's ``append_token`` for pool-pressure injection."""
        engine.faults = self
        mgr = engine.scheduler.manager
        orig = mgr.append_token
        plan = self.plan

        def wrapped(seq_id: int) -> int:
            self.appends += 1
            if (plan.oob_at_append is not None
                    and plan.oob_at_append <= self.appends
                    < plan.oob_at_append + plan.oob_count):
                self.injected_oob += 1
                raise OutOfBlocks(
                    f"injected OutOfBlocks (append #{self.appends})")
            return orig(seq_id)

        mgr.append_token = wrapped
        return self

    # ------------------------------------------------------------ hooks --
    def before_execute(self, sb) -> None:
        """Engine hook, both dispatch paths: one call per device step."""
        self.steps += 1
        if self.plan.raise_at_step == self.steps:
            raise FaultInjected(
                f"injected step fault at dispatched step {self.steps} "
                f"(kind {sb.kind})")

    def on_emit(self) -> None:
        """Emit-worker hook: one call per drained step, BEFORE the host
        sync."""
        self.emissions += 1
        if self.plan.emit_delay_s > 0:
            time.sleep(self.plan.emit_delay_s)
        if (self.plan.kill_emit_at is not None
                and self.emissions >= self.plan.kill_emit_at):
            raise WorkerKilled()

    def on_spill(self) -> bool:
        """Engine spill-sink hook: one call per device->host spill attempt.
        Returns False to drop the spill (the evicted page is destroyed —
        DROPPED — exactly what a failed copy looks like to the allocator)."""
        self.spills += 1
        p = self.plan
        if (p.spill_drop_at is not None
                and p.spill_drop_at <= self.spills
                < p.spill_drop_at + p.spill_drop_count):
            self.injected_spill_drops += 1
            return False
        return True

    def on_prefetch(self) -> Tuple[bool, int]:
        """Engine prefetch hook: one call per host->HBM upload started.
        Returns (ok, extra_delay_turns) — ``ok=False`` makes the flight
        abort at landing (staging page freed, payload back on the host
        store); the delay stretches the landing turn (slow host link)."""
        self.prefetches += 1
        p = self.plan
        ok = True
        if (p.prefetch_fail_at is not None
                and p.prefetch_fail_at <= self.prefetches
                < p.prefetch_fail_at + p.prefetch_fail_count):
            self.injected_prefetch_fails += 1
            ok = False
        return ok, p.prefetch_delay_turns

    def on_turn(self, frontend) -> None:
        """Frontend hook, top of every loop turn: seeded cancel storms."""
        self.turns += 1
        if self.turns not in self.plan.cancel_at_turns:
            return
        open_streams = sorted(frontend._streams.items())
        n = int(round(len(open_streams) * self.plan.cancel_frac))
        if not n:
            return
        picks = self.rng.choice(len(open_streams), size=n, replace=False)
        for i in sorted(int(j) for j in picks):
            frontend.cancel(open_streams[i][1])
            self.injected_cancels += 1
