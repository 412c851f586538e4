"""The training loop: the cross-entropy LM loss (plus the MoE auxiliary
terms) and AdamW. The port of the JAX package's ``training/train.py``.

Gradients come from autograd over the models' plain PyTorch path, as the
reference's come from ``jax.grad`` over plain jnp: no hand-written kernel
has a backward, and the kernel wrappers refuse a call under autograd, so
training runs with ``use_kernel=False`` (``COOPT``, the reference
trainer's mode). ``make_train_step`` returns the step function;
``Trainer`` is the host-side loop of the launcher and the example.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import ModelConfig
from repro_torch.core.coopt import COOPT, CoOptConfig
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import check_device
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update


def loss_fn(model, params, batch, coopt: CoOptConfig,
            moe_lb_weight: float = 0.01, moe_z_weight: float = 1e-3):
    """(loss, metrics): the mean next-token NLL of the bf16 logits in f32,
    plus the weighted load-balance and router-z terms where the model
    returns them."""
    logits, aux = model.forward(params, batch, coopt)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss = nll.mean()
    metrics = {"nll": loss}
    if aux and "load_balance" in aux:
        loss = loss + moe_lb_weight * aux["load_balance"] \
            + moe_z_weight * aux["router_z"]
        metrics.update(load_balance=aux["load_balance"],
                       router_z=aux["router_z"],
                       dropped=aux.get("dropped",
                                       torch.zeros((), device=loss.device)))
    metrics["loss"] = loss
    return loss, metrics


def loss_and_grads(model, params, batch, coopt: CoOptConfig):
    """(metrics, grads): the loss metrics, detached, and the gradient of
    the loss for every leaf of ``params`` (in the flatten order of
    ``repro_torch.tree``, zeros for a leaf the loss does not reach). The
    params need not require grad: autograd runs on detached aliases of
    their storage."""
    live = [p.detach().requires_grad_() for p in tree_util.leaves(params)]
    loss, metrics = loss_fn(model, tree_util.unflatten(params, live), batch,
                            coopt)
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return {k: v.detach() for k, v in metrics.items()}, list(grads)


def step_grads(model, params, batch, coopt: CoOptConfig,
               num_microbatches: int = 1):
    """(metrics, grads): what one train step applies. With
    ``num_microbatches > 1`` (gradient accumulation) the batch is split on
    its leading axis, each part's gradients are added into f32
    accumulators divided by n, and the metrics are averaged."""
    n = num_microbatches
    if n == 1:
        return loss_and_grads(model, params, batch, coopt)
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split into {n} microbatches")
    b = B // n
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_util.leaves(params)]
    div = torch.tensor(float(n), device=acc[0].device)
    parts = []
    for i in range(n):
        mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        m, g = loss_and_grads(model, params, mb, coopt)
        for a, x in zip(acc, g):
            a.add_(x.float() / div)
        del g
        parts.append(m)
    metrics = {k: torch.stack([m[k] for m in parts]).mean(0)
               for k in parts[0]}
    return metrics, acc


def make_train_step(cfg: ModelConfig, coopt: CoOptConfig = COOPT, *,
                    lr: float = 3e-4, weight_decay: float = 0.1,
                    grad_clip: float = 1.0,
                    num_microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics), the
    parameters and moments updated in place (the call returns the same
    tensors; ``opt_state.step`` is new): ``step_grads``, then AdamW."""
    model = get_model(cfg)

    def train_step(params, opt_state: AdamWState, batch):
        metrics, grads = step_grads(model, params, batch, coopt,
                                    num_microbatches)
        params, opt_state, gnorm = adamw_update(
            params, tree_util.unflatten(params, grads), opt_state, lr=lr,
            weight_decay=weight_decay, grad_clip=grad_clip)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays or tensors) on ``device``, dtypes kept."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


@dataclass
class Trainer:
    """The host-side loop: parameters from ``model.init(seed)`` unless
    ``params`` is given (e.g. converted JAX weights), AdamW state, and one
    train step per batch. Runs on the card unless ``device="cpu"``."""
    cfg: ModelConfig
    coopt: CoOptConfig = COOPT
    lr: float = 3e-4
    seed: int = 0
    device: Any = "cuda"
    params: Optional[Dict[str, Any]] = None
    history: list = field(default_factory=list)

    def __post_init__(self):
        self.device = check_device(self.device)
        self.model = get_model(self.cfg)
        if self.params is None:
            self.params = self.model.init(self.seed, self.device)
        self.opt_state = adamw_init(self.params)
        self._step = make_train_step(self.cfg, self.coopt, lr=self.lr)

    def step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        self.params, self.opt_state, metrics = self._step(
            self.params, self.opt_state, to_device(batch, self.device))
        out = {k: float(v) for k, v in metrics.items()}
        self.history.append(out)
        return out

    def fit(self, batches, steps: int, log_every: int = 10,
            log: Optional[Callable[[str], None]] = print):
        it = iter(batches)
        t0 = time.perf_counter()
        for i in range(steps):
            m = self.step(next(it))
            if log and (i % log_every == 0 or i == steps - 1):
                log(f"step {i:4d}  loss {m['loss']:.4f}  "
                    f"nll {m['nll']:.4f}  gnorm {m['grad_norm']:.3f}  "
                    f"({time.perf_counter() - t0:.1f}s)")
        return self.history
