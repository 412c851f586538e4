"""End-to-end training: a ~100M-parameter qwen3-family model (or its MoE
variant) for a few hundred steps on the synthetic corpus, with AdamW, the
MoE auxiliary losses and a checkpoint. The port of the JAX package's
``examples/train_small.py``.

  python -m repro_torch.examples.train_small [--steps 200] [--moe]
  python -m repro_torch.examples.train_small --steps 20 --device cpu
"""
import argparse

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import TrainPipeline
from repro_torch.training import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--moe", action="store_true",
                    help="train the MoE (mixtral-family) variant instead")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    arch = "mixtral-8x22b-reduced" if args.moe else "qwen3-4b-reduced"
    # ~100M-param variant: widen the reduced config
    cfg = get_config(arch).replace(d_model=512, d_ff=1408, num_layers=4,
                                   num_heads=8, num_kv_heads=4,
                                   vocab_size=8192)
    tr = Trainer(cfg, lr=1e-3, device=args.device)
    n = tr.model.param_count()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps")

    pipe = TrainPipeline(cfg.vocab_size, batch=8, seq_len=128, seed=0)
    hist = tr.fit(pipe, steps=args.steps, log_every=10)
    print(f"\nloss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    assert hist[-1]["loss"] < hist[0]["loss"], "loss must decrease"

    if args.ckpt:
        save_checkpoint(args.ckpt, tr.params, step=args.steps)
        print("saved", args.ckpt)
    return hist


if __name__ == "__main__":
    main()
