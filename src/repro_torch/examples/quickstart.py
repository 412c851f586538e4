"""Quickstart: build an LLM-CoOpt engine, serve a few requests, and compare
the paper's five technique modes on the same prompts.

  python -m repro_torch.examples.quickstart                # on the card
  python -m repro_torch.examples.quickstart --device cpu   # on the CPU

Every mode runs the hand-written kernels (on CPU tensors their plain
PyTorch versions). original, opt-gqa and opt-pa compute the same bf16
attention in three layouts, so their greedy tokens should agree: a quick
canary for changes to the attention paths.
"""
import argparse
import copy

from repro_torch.configs import get_config
from repro_torch.core.coopt import MODES
from repro_torch.data import sharegpt_stream
from repro_torch.models import get_model
from repro_torch.serving import Engine, EngineConfig

ARCH = "qwen3-4b-reduced"          # any ported arch id (+-reduced)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(ARCH)
    print(f"model: {cfg.name}  ({cfg.num_layers}L, d={cfg.d_model}, "
          f"H={cfg.num_heads}/kv{cfg.num_kv_heads})")

    ecfg = EngineConfig(num_lanes=2, max_len=192,
                        prefill_buckets=(16, 32, 64))
    requests = sharegpt_stream(cfg.vocab_size, 3, seed=0, scale=0.05)
    for r in requests:
        r.max_new_tokens = 8
    # one set of weights for every mode
    params = get_model(cfg).init(ecfg.seed, args.device)

    outputs = {}
    for mode, coopt in MODES.items():
        engine = Engine(cfg, coopt.replace(use_kernel=True), ecfg,
                        params=params, device=args.device)
        rs = [copy.deepcopy(r) for r in requests]
        for r in rs:
            engine.add_request(r)
        engine.run()
        outputs[mode] = [r.output for r in rs]
        print(f"{mode:9s}  throughput={engine.stats.throughput():7.1f} tok/s"
              f"  first outputs: {rs[0].output}")

    same = outputs["original"] == outputs["opt-gqa"] == outputs["opt-pa"]
    print(f"\nopt-gqa / opt-pa greedy-identical to original: {same}")
    print("opt-kv / coopt differ only by fp8 cache rounding "
          "(paper Tables 1-2: accuracy preserved)")
    return outputs


if __name__ == "__main__":
    main()
