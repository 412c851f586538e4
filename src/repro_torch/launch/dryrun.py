"""Dry run: build every (architecture x input shape) cell on the meta
device, run its step once, count its FLOPs and bytes, and say whether it
fits one 80 GiB H100.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape long_500k
  python -m repro_torch.launch.dryrun --all [--mode coopt] [--out F.jsonl]

Nothing is allocated on any device: the inputs are meta tensors
(``StepBundle.meta_args``) and every op computes only shapes. The step
runs the plain PyTorch path (``use_kernel=False``; the record says
``"path": "plain"``): a hand-written kernel is bound through ``ctypes``
and cannot take a meta tensor. The write path's boolean mask is taken as
all true (``meta_nonzero_assume_all_nonzero``): a dry step writes every
token, as the real one does.

A record keeps the JAX package's keys where they mean the same thing:
  * ``status`` ok / skipped / error, ``kind`` train / prefill / decode;
  * ``cost.flops``: what ``torch.utils.flop_counter.FlopCounterMode``
    counts (its formulas, applied by ``MetaStep``), the matmul-class ops
    (mm, bmm, addmm, einsum's products, convolutions, SDPA), forward and
    backward. The JAX package's
    ``cost_analysis`` counts every op, so the two FLOP figures are not the
    same quantity. FlopCounterMode sees every layer's ops, so there is no
    scan body counted once to undo (the JAX package's ``hlo_cost.py`` has
    no counterpart);
  * ``cost["bytes accessed"]``: per op, the bytes of its tensor inputs and
    outputs (XLA's per-op count); a gather counts what it returns, a
    scatter what it writes, a view nothing. This is the plain path's
    traffic: a decode step's plain attention dequantizes each window page
    to f32 and back to bf16, so at qwen3-4b x long_500k it is ~3x what
    the kernel step moves;
  * ``cost["min_bytes"]``: the bytes the step must move, each once: every
    input it reads (a gathered input only the rows it gathers, e.g. a
    decode step's window pages), the rows it writes into an input, and its
    new outputs; intermediates are not counted. The roofline's M term
    (``launch.inspect_cell``);
  * ``memory.argument_bytes``: params (+ AdamW's f32 moments for train),
    cache and inputs, exact; ``memory.output_bytes``: the returned tensors
    that are not inputs updated in place; ``memory.temp_bytes``: the peak
    of live intermediate bytes over the run (a ``TorchDispatchMode``
    tracks each new storage until it is freed);
  * ``collective_bytes``: 0 on one card.
``fits_h100_80gib`` holds when argument + temp bytes fit ``mesh.H100_
USABLE_BYTES``; with a card present the record also carries its name and
power limit.

A train step of M microbatches runs one microbatch's ops M times on the
same shapes, so every count is affine in M (for M >= 2). Past
``EXTEND_MICROBATCHES`` the dry run counts the steps of 2 and 3
microbatches of the same size and extends the line to M
(``"microbatches_counted": [2, 3]``): deepseek-67b x train_4k runs 5
microbatches, not 16. ``whole=True`` runs all M.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
import weakref
from contextlib import contextmanager
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch import tree as tree_util
from repro_torch.configs import ALL_IDS, ARCH_IDS, SHAPES
from repro_torch.core.coopt import COOPT, MODES
from repro_torch.launch.mesh import H100_USABLE_BYTES
from repro_torch.launch.steps import ShapeSkipped, make_step, tree_nbytes

_aten = torch.ops.aten
# ops that move no bytes (views and metadata)
_VIEWS = {_aten.view.default, _aten._unsafe_view.default,
          _aten.reshape.default, _aten.expand.default, _aten.permute.default,
          _aten.transpose.int, _aten.t.default, _aten.select.int,
          _aten.slice.Tensor, _aten.unsqueeze.default,
          _aten.squeeze.dim, _aten.squeeze.default, _aten.as_strided.default,
          _aten.alias.default, _aten.detach.default, _aten.unbind.int,
          _aten.split.Tensor, _aten.split_with_sizes.default,
          _aten.view_as_real.default, _aten.view_as_complex.default,
          _aten.unfold.default, _aten.diagonal.default}
# ops that read only the rows they return (the indexed input is skipped)
_GATHERS = {_aten.index.Tensor, _aten.gather.default,
            _aten.index_select.default, _aten.embedding.default}
# ops that write only the rows they are given (the target is skipped,
# the written values counted twice: read, then written)
_SCATTERS = {_aten.index_put_.default, _aten.index_put.default,
             _aten._index_put_impl_.default, _aten.scatter_.src,
             _aten.scatter.src, _aten.scatter_.value, _aten.scatter.value,
             _aten.index_copy_.default, _aten.index_add_.default,
             _aten.scatter_add_.default, _aten.scatter_add.default}


# train steps of more microbatches than this are counted at 2 and 3 and
# extended (see the module note)
EXTEND_MICROBATCHES = 5


def _tensors(x):
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_Tensor = torch.Tensor


def _key(x):
    """A hashable key of an op argument: a tensor by its metadata."""
    if isinstance(x, _Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple([_key(v) for v in x])
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in sorted(x.items()))
    try:
        hash(x)
    except TypeError:
        return repr(x)
    return x


def _spec(t):
    return (tuple(t.shape), t.stride(), t.dtype) \
        if isinstance(t, _Tensor) else t


def _build(s):
    if isinstance(s, tuple) and len(s) == 3 and isinstance(s[2], torch.dtype):
        return torch.empty_strided(s[0], s[1], dtype=s[2], device="meta")
    if isinstance(s, list):
        return [_build(x) for x in s]
    if isinstance(s, tuple):
        return tuple(_build(x) for x in s)
    return s


class MetaStep(TorchDispatchMode):
    """Runs a step's ops on meta tensors and counts their FLOPs (with
    ``FlopCounterMode``'s formulas, ``flop_counter.flop_registry``) and the
    bytes they access, and tracks the live bytes of the storages they
    create (each counted from the op that made it until it is freed) and
    their peak. Storages of ``known`` tensors (the step's inputs) are never
    counted.

    A meta op computes only its outputs' shapes and strides, mostly in
    Python (~0.3 ms an op), and ``FlopCounterMode`` adds ~0.1 ms; every
    layer of a model repeats the same ops on the same shapes. So an op that
    neither mutates nor aliases its inputs is run and counted once per
    signature (the op, its tensors' shapes, strides and dtypes, its other
    arguments), and later calls get new empty meta tensors of the outputs'
    shapes and strides, with the first call's counts. Mutating and view
    ops, and ops with an output off the meta device (a host scalar),
    always run; with ``memo=False`` every op runs (the reference the tests
    hold the memoized counts to)."""

    def __init__(self, known=(), memo: bool = True):
        super().__init__()
        self._use_memo = memo
        self._seen = weakref.WeakSet(t.untyped_storage() for t in known)
        # the inputs' storages, held so that their ids stay theirs
        self._inputs = {id(st): st for st in
                        (t.untyped_storage() for t in known)}
        self._once = set()
        self._memo = {}
        self._pure = {}
        self._refs = {}
        self.flops = 0
        self.live = 0
        self.peak = 0
        self.bytes_accessed = 0
        self.min_bytes = 0

    def _freed(self, ref) -> None:
        self.live -= self._refs.pop(id(ref))[1]

    def _count(self, st) -> None:
        n = st.nbytes()
        ref = weakref.ref(st, self._freed)
        self._refs[id(ref)] = (ref, n)
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _must_move(self, func, args, kwargs, out) -> None:
        """Count the step's inputs this op touches into ``min_bytes``: a
        gather's indexed input by the rows it returns, a scatter's target
        by the values it writes (each call), any other input read whole,
        and an input updated in place written whole, once each (a view by
        its offset and size)."""
        ins = _tensors((args, kwargs))
        for i, t in enumerate(ins):
            if id(t.untyped_storage()) not in self._inputs:
                continue
            if i == 0 and func in _GATHERS:
                self.min_bytes += sum(map(_nbytes, _tensors(out)))
            elif i == 0 and func in _SCATTERS:
                self.min_bytes += ins[-1].numel() * t.element_size()
            else:
                writes = i == 0 and func._schema.is_mutable
                key = (id(t.untyped_storage()), t.storage_offset(),
                       _nbytes(t), writes)
                if key not in self._once:
                    self._once.add(key)
                    self.min_bytes += _nbytes(t)

    def is_new(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is not one of the step's inputs."""
        return id(t.untyped_storage()) not in self._inputs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _VIEWS:        # no bytes, no FLOPs, the input's storage
            return func(*args, **kwargs)
        pure = self._pure.get(func)
        if pure is None:
            schema = func._schema
            pure = self._pure[func] = self._use_memo and \
                not schema.is_mutable and all(
                    r.alias_info is None for r in schema.returns)
        key = (func, _key(args), _key(kwargs) if kwargs else ()) \
            if pure else None
        hit = self._memo.get(key) if pure else None
        if hit is not None:
            spec, moved, flops = hit
            out = _build(spec)
            self.bytes_accessed += moved
            self.flops += flops
            self._must_move(func, args, kwargs, out)
            # fresh storages, never seen
            for t in ((out,) if isinstance(out, _Tensor) else _tensors(out)):
                st = t.untyped_storage()
                self._seen.add(st)
                self._count(st)
            return out
        out = func(*args, **kwargs)
        moved = _moved(func, args, kwargs, out)
        formula = flop_registry.get(func._overloadpacket)
        flops = 0 if formula is None else \
            formula(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if pure and all(t.is_meta for t in outs):
            self._memo[key] = (tree_map(_spec, out), moved, flops)
        self.bytes_accessed += moved
        self.flops += flops
        self._must_move(func, args, kwargs, out)
        for t in outs:
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen.add(st)
                self._count(st)
        return out


def _moved(func, args, kwargs, out) -> int:
    """The bytes one op accesses."""
    if func in _VIEWS:
        return 0
    ins = _tensors((args, kwargs))
    if func in _GATHERS:
        return sum(map(_nbytes, ins[1:] + _tensors(out)))
    if func in _SCATTERS:
        return sum(map(_nbytes, ins[1:])) + sum(map(
            _nbytes, [t for t in ins[1:] if t.is_floating_point()]))
    return sum(map(_nbytes, ins + _tensors(out)))


@contextmanager
def _nonzero_assumed():
    import torch.fx.experimental._config as fx_config
    saved = fx_config.meta_nonzero_assume_all_nonzero
    fx_config.meta_nonzero_assume_all_nonzero = True
    try:
        yield
    finally:
        fx_config.meta_nonzero_assume_all_nonzero = saved


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    None without a card."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _measure(bundle) -> dict:
    """One run of ``bundle``'s step on meta inputs: its counts."""
    args = bundle.meta_args()
    tracker = MetaStep(tree_util.leaves(args))
    with _nonzero_assumed(), tracker:
        out = bundle.fn(*args)
    out_bytes = sum(_nbytes(t) for t in _tensors(out) if tracker.is_new(t))
    return {"flops": tracker.flops, "bytes accessed": tracker.bytes_accessed,
            "min_bytes": tracker.min_bytes + out_bytes,
            "output_bytes": out_bytes, "temp_bytes": tracker.peak}


def run_one(arch: str, shape, *, coopt=COOPT, card_line=None,
            verbose: bool = True, whole: bool = False) -> dict:
    """The dry run of one cell (``shape``: a name or an ``InputShape``).
    ``whole`` runs every microbatch of a train step (see the module
    note)."""
    name = shape if isinstance(shape, str) else shape.name
    rec = {"arch": arch, "shape": name, "device": "meta", "path": "plain"}
    if card_line:
        rec["card"] = card_line
    plain = coopt.replace(use_kernel=False)
    try:
        bundle = make_step(arch, shape, plain, device="meta")
    except ShapeSkipped as e:
        rec["status"] = "skipped"
        rec["reason"] = str(e)
        if verbose:
            print(f"[skip] {arch} x {name}: {e}", flush=True)
        return rec
    arg_bytes = tree_nbytes(bundle.args)
    t0 = time.perf_counter()
    m = bundle.microbatches
    if m > EXTEND_MICROBATCHES and not whole:
        b = bundle.shape.global_batch // m
        two, three = (_measure(make_step(
            arch, dataclasses.replace(bundle.shape, global_batch=n * b),
            plain, device="meta", num_microbatches=n)) for n in (2, 3))
        got = {k: two[k] + (m - 2) * (three[k] - two[k]) for k in two}
        rec["microbatches_counted"] = [2, 3]
    else:
        got = _measure(bundle)
    rec["run_s"] = round(time.perf_counter() - t0, 2)
    rec["status"] = "ok"
    rec["kind"] = bundle.kind
    rec["long_window"] = bundle.long_window
    rec["microbatches"] = m
    rec["cost"] = {"flops": got["flops"],
                   "bytes accessed": got["bytes accessed"],
                   "min_bytes": got["min_bytes"]}
    rec["memory"] = {"argument_bytes": arg_bytes,
                     "output_bytes": got["output_bytes"],
                     "temp_bytes": got["temp_bytes"]}
    rec["collective_bytes"] = 0
    rec["fits_h100_80gib"] = \
        arg_bytes + got["temp_bytes"] <= H100_USABLE_BYTES
    if verbose:
        print(f"[ok] {arch} x {name} ({bundle.kind}) run={rec['run_s']}s "
              f"flops={rec['cost']['flops']:.3e} "
              f"args={arg_bytes / 2**30:.2f}GiB "
              f"temp={got['temp_bytes'] / 2**30:.2f}GiB "
              f"fits={rec['fits_h100_80gib']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ALL_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) combination")
    ap.add_argument("--mode", default="coopt", choices=list(MODES),
                    help="LLM-CoOpt technique set (default: coopt)")
    ap.add_argument("--out", default=None, help="append JSON records here")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("need --arch and --shape (or --all)")
    combos = ([(a, s) for a in ARCH_IDS for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    coopt, card_line = MODES[args.mode], card()

    records, failures = [], 0
    for arch, shape in combos:
        try:
            rec = run_one(arch, shape, coopt=coopt, card_line=card_line)
        except Exception as e:
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        records.append(rec)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    ok = sum(r["status"] == "ok" for r in records)
    sk = sum(r["status"] == "skipped" for r in records)
    fit = sum(bool(r.get("fits_h100_80gib")) for r in records)
    print(f"\n== dry-run: {ok} ok ({fit} fit one H100), {sk} skipped, "
          f"{failures} failed, {len(records)} total ==")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
