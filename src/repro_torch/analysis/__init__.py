"""cooptlint for the port: static analysis of the serving stack's and the
CUDA kernels' unwritten contracts (``python -m repro_torch.analysis
src/repro_torch``).

The port's counterpart of the JAX package's ``repro.analysis``, with its
finding codes where a pass has a torch meaning:

  COOPT001  host-sync        stray device->host syncs on the serving step
                             path (``repro_torch.analysis.host_sync``)
  COOPT003  mesh-ctx scoping  un-scoped ``ops.set_mesh_ctx`` calls
                             (``repro_torch.analysis.mesh_ctx``)
  COOPT004  capture safety   CUDA-graph step bodies reading state that is
                             reassigned after capture
                             (``repro_torch.analysis.capture_safety``)
  COOPT005  page sentinel    page- and slot-table loads of the CUDA kernels
                             (``kernels/csrc/*.cu``, ``*.cuh``) unguarded
                             against ``-1`` (``repro_torch.analysis.
                             page_guard``)
  COOPT006  fault swallowing  blanket ``except`` handlers that drop
                             exceptions inside serving loops/workers
                             (``repro_torch.analysis.exceptions``)

Not applicable, by name: COOPT002 (``donation.py``, use after buffer
donation: torch has no donation, a step updates its tensors in place) and
the VMEM estimator of ``pallas_vmem.py`` (a TPU core's VMEM budget; a CUDA
kernel's shared memory and registers are checked where it is built and
launched, ``kernels/cuda.py`` and the wrappers).

Usage::

    python -m repro_torch.analysis [paths...] [--format text|json]
        [--baseline FILE] [--write-baseline] [--select CODES]

Inline suppression: append ``# coopt: allow[COOPT001]`` (``//`` in CUDA;
comma-separate multiple codes) to the offending line or the line directly
above it, with a short rationale in the surrounding comment. Grandfathered
findings live in the committed baseline
(``src/repro_torch/analysis/baseline.json``), each with a one-line
justification; the CLI exits non-zero on any finding that is neither
suppressed nor baselined.
"""
from repro_torch.analysis.core import (Finding, load_baseline, run_suite,
                                       write_baseline)

__all__ = ["Finding", "run_suite", "load_baseline", "write_baseline"]
