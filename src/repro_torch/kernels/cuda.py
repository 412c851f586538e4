"""Build, load and count the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded through
``ctypes`` (no PyTorch headers, so a build takes seconds). All sources are
compiled at once, one ``nvcc`` process each, into ``_build/`` beside this
file (or ``$REPRO_TORCH_BUILD_DIR``); a library's file name carries a hash
of its sources, so an edited source is rebuilt and a stale one never
loaded. Nothing is built or imported at module import time.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else. A launch of K2-K7 that returns
its softmax state (``return_state``, the sharded layer's) counts under the
kernel's name with ``_state`` appended (``state_name``). Under CUDA-graph capture nothing
runs on the card, so ``capture_launches`` takes the counts a capture adds
back out and hands them to the graph's owner, which adds them once for
each replay (``add_launches``): ``LAUNCHES`` stays the launches the card
ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterator

_CSRC = Path(__file__).resolve().parent / "csrc"
_HEADERS = ("paged_attention.cuh", "mma_attention.cuh", "latent_mma.cuh")
SOURCES = {                      # library -> source file
    "kv_cache_write": "kv_cache_write.cu",
    "paged_gqa_decode": "paged_gqa_decode.cu",
    "flash_chunk_prefill": "flash_chunk_prefill.cu",
    "paged_latent_decode": "paged_latent_decode.cu",
    "latent_chunk_prefill": "latent_chunk_prefill.cu",
    "flash_prefill": "flash_prefill.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the kernels that can return their softmax state (m, l)
STATE_KERNELS = ("paged_pool_decode", "paged_pool_decode_visits",
                 "flash_chunk_prefill", "paged_latent_decode",
                 "paged_latent_decode_visits", "latent_chunk_prefill")
LAUNCHES: Dict[str, int] = {"kv_cache_write": 0, "paged_pool_decode": 0,
                            "paged_pool_decode_visits": 0,
                            "flash_chunk_prefill": 0,
                            "paged_latent_decode": 0,
                            "paged_latent_decode_visits": 0,
                            "latent_chunk_prefill": 0, "flash_prefill": 0,
                            **{k + "_state": 0 for k in STATE_KERNELS}}
BUILD_LOG: Dict[str, str] = {}   # library -> nvcc output (ptxas -v report)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "kv_cache_write": [_P] * 3 + [_L, _I, _I] + [_P] * 4 + [_L] + [_I] * 4
    + [_P],
    "paged_pool_decode": [_P] * 13 + [_I] * 11 + [_F, _P],
    "paged_pool_decode_visits": [_P] * 14 + [_I] * 11 + [_F, _P],
    "flash_chunk_prefill": [_P] * 13 + [_I] * 11 + [_F, _P],
    "paged_latent_decode": [_P] * 10 + [_I] * 10 + [_F, _P],
    "paged_latent_decode_visits": [_P] * 11 + [_I] * 10 + [_F, _P],
    "paged_latent_decode_info": [_I] * 5 + [ctypes.POINTER(_I)],
    "latent_chunk_prefill": [_P] * 12 + [_I] * 10 + [_F, _P],
    "latent_chunk_prefill_info": [_I, _I, _I, ctypes.POINTER(_I)],
    "flash_prefill": [_P] * 4 + [_I] * 8 + [_F, _P],
    "kv_cache_write_info": [_I] * 3 + [ctypes.POINTER(_I)],
    "paged_gqa_decode_info": [_I] * 3 + [ctypes.POINTER(_I)],
    "flash_chunk_prefill_info": [_I] * 3 + [ctypes.POINTER(_I)],
}
_ENTRIES = {"kv_cache_write": ("kv_cache_write", "kv_cache_write_info"),
            "paged_gqa_decode": ("paged_pool_decode",
                                 "paged_pool_decode_visits",
                                 "paged_gqa_decode_info"),
            "flash_chunk_prefill": ("flash_chunk_prefill",
                                    "flash_chunk_prefill_info"),
            "paged_latent_decode": ("paged_latent_decode",
                                    "paged_latent_decode_visits",
                                    "paged_latent_decode_info"),
            "latent_chunk_prefill": ("latent_chunk_prefill",
                                     "latent_chunk_prefill_info"),
            "flash_prefill": ("flash_prefill",)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name: str) -> None:
    LAUNCHES[name] += 1


def state_name(name: str, return_state: bool) -> str:
    """The ``LAUNCHES`` key of a launch of ``name``: with ``_state``
    appended where it returns its softmax state."""
    return name + "_state" if return_state else name


@contextmanager
def capture_launches() -> Iterator[Dict[str, int]]:
    """Around a CUDA-graph capture: yields a dict that, on exit, holds the
    launches the wrappers counted inside the block (the graph's kernels),
    which are taken back out of ``LAUNCHES``."""
    before = dict(LAUNCHES)
    captured: Dict[str, int] = {}
    try:
        yield captured
    finally:
        for k, n in before.items():
            if LAUNCHES[k] != n:
                captured[k] = LAUNCHES[k] - n
                LAUNCHES[k] = n


def add_launches(counts: Dict[str, int]) -> None:
    """One replay of a graph whose capture counted ``counts``."""
    for k, n in counts.items():
        LAUNCHES[k] += n


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               Path(__file__).resolve().parent / "_build"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + _HEADERS:
        h.update((_CSRC / f).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every library that is not built yet, all ``nvcc`` processes
    at once. Returns the seconds spent. Raises on any compile error."""
    with _LOCK:
        todo = {n: _lib_path(n) for n in SOURCES}
        todo = {n: p for n, p in todo.items() if not p.exists()}
        if not todo:
            return 0.0
        nvcc = _nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, p)
        failed = []
        for n, (proc, tmp, p) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[n] = out
            if proc.returncode != 0:
                failed.append(f"{SOURCES[n]}:\n{out}")
            else:
                os.replace(tmp, p)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    with _LOCK:
        lib = ctypes.CDLL(str(_lib_path(name)))
        for entry in _ENTRIES[name]:
            fn = getattr(lib, entry)
            fn.argtypes = _ARGTYPES[entry]
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def info(library_name: str, entry: str, keys, *args, device=None) -> dict:
    """A library's ``*_info`` entry (``cudaFuncGetAttributes`` of one
    instantiation, and its launch geometry) called with ``args`` on
    ``device``: {key: int} in the order of ``keys``."""
    import torch
    out = (ctypes.c_int * len(keys))()
    with torch.cuda.device(device):
        err = getattr(library(library_name), entry)(*args, out)
    check(err, entry)
    return dict(zip(keys, out))


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (NULL) for a missing operand."""
    return None if t is None else t.data_ptr()
