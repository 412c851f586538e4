"""Random weights from ``--seed``, made on the device in the type they are
served in, one generator call per stacked leaf. The leaves' names and
shapes are the program's parameter layout (``param_shapes``); the values
are the benchmark's, and the reference reads the same tensors.

Norm scales are drawn around 1 and the QKV biases at std 0.5 (the program
inits them to ones and zeros), so the reference checks that both are
applied."""
from __future__ import annotations

import math


def _fill(torch, shape, init, dtype, gen, device):
    t = torch.empty(shape, dtype=dtype, device=device)
    if init == "ones":
        return t.normal_(1.0, 0.1, generator=gen)
    if init == "zeros":
        return t.normal_(0.0, 0.5, generator=gen)
    if init == "embed":
        return t.normal_(0.0, 0.02, generator=gen)
    if init == "normal":
        return t.normal_(0.0, 1.0 / math.sqrt(max(shape[-2], 1)),
                         generator=gen)
    raise ValueError(f"no rule for init {init!r}")


def make_params(torch, model, seed: int, device):
    """The model's parameter dict, drawn from one ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    spec = model.param_shapes()

    def make(leaf):
        return _fill(torch, leaf[0], leaf[1], leaf[2], gen, device)
    return {"embed": make(spec["embed"]),
            "segments": [{k: make(v) for k, v in seg.items()}
                         for seg in spec["segments"]],
            "final_norm": make(spec["final_norm"]),
            "lm_head": make(spec["lm_head"])}
