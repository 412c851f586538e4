"""The training launcher, the port of the JAX package's
``repro.launch.train``: the same flags and log lines, on one card.

  python -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 100 \
      --batch 8 --seq 128                     # on the card
  python -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 20 \
      --device cpu                            # on the CPU

``--mesh host`` is the one card. The JAX package's ``single`` and ``multi``
meshes are the TPU v5e production pods; nothing here lays a model out on
them, and the launcher refuses them. Batches come from ``TrainPipeline``;
a vlm model gets zero ``patches`` and whisper zero ``frames``, as the
reference's launcher gives them. Training runs the plain PyTorch path under
autograd: ``--mode`` picks the technique flags, never the kernels.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.coopt import MODES
from repro_torch.data import TrainPipeline
from repro_torch.models import get_model
from repro_torch.models.transformer import check_device
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import make_train_step, to_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mode", default="coopt", choices=list(MODES))
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise ValueError(f"--mesh {args.mesh} is a TPU v5e production mesh, "
                         "which does not apply to the port: it trains on "
                         "one card (--mesh host)")
    device = check_device(args.device)
    arch = args.arch + ("-reduced" if args.reduced else "")
    cfg = get_config(arch)
    coopt = MODES[args.mode]
    model = get_model(cfg)
    params = model.init(0, device)
    opt_state = adamw_init(params)
    step_fn = make_train_step(cfg, coopt, lr=args.lr)

    pipe = TrainPipeline(cfg.vocab_size, args.batch, args.seq)
    t0 = time.perf_counter()
    for i, raw in zip(range(args.steps), pipe):
        batch = to_device(raw, device)
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.num_patches, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        if cfg.family == "whisper":
            batch["frames"] = torch.zeros(
                (args.batch, cfg.num_frames, cfg.d_model),
                dtype=torch.bfloat16, device=device)
        params, opt_state, m = step_fn(params, opt_state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)

    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print("checkpoint saved to", args.ckpt)
    return params


if __name__ == "__main__":
    main()
