"""End-to-end serving example: a ShareGPT-mix workload through the
continuous-batching engine with the full LLM-CoOpt stack, reporting the
paper's Eq. 11/12 metrics and the block manager's pool fragmentation (the
paper's Fig. 3).

  python -m repro_torch.examples.serve_continuous_batching \\
      [--arch internvl2-2b] [--reduced] [--mode coopt] [--requests 12] \\
      [--device cpu]

The engine runs the hand-written kernels (on CPU tensors their plain
PyTorch versions). A vlm model's lanes hold its patch stub too, so
``max_len`` grows by ``num_patches``.
"""
import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core.coopt import MODES
from repro_torch.data import RequestStream
from repro_torch.serving import Engine, EngineConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="coopt", choices=list(MODES))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch + ("-reduced" if args.reduced else ""))
    stub = cfg.num_patches if cfg.family == "vlm" else 0
    ecfg = EngineConfig(num_lanes=args.lanes, max_len=256 + stub,
                        prefill_buckets=(16, 32, 64, 128))
    engine = Engine(cfg, MODES[args.mode].replace(use_kernel=True),
                    ecfg, device=args.device)
    stream = RequestStream(cfg.vocab_size, seed=0, scale=0.1)

    pending = stream.take(args.requests, max_new_tokens=16)
    t0 = time.perf_counter()
    step = 0
    while pending or engine.scheduler.has_work:
        # Poisson-ish arrivals: feed 1 request every 2 engine steps
        if pending and step % 2 == 0:
            engine.add_request(pending.pop(0))
        engine.step()
        step += 1
        if step % 20 == 0:
            frag = engine.scheduler.manager.fragmentation()
            print(f"  step {step:4d}  running={len(engine.scheduler.running)}"
                  f"  waiting={len(engine.scheduler.waiting)}"
                  f"  pool fragmentation={frag:.2f}")
    wall = time.perf_counter() - t0

    s = engine.stats
    print(f"\narch={cfg.name} mode={args.mode} device={engine.device}")
    print(f"requests served : {args.requests}")
    print(f"tokens generated: {s.generated_tokens}")
    print(f"latency  (Eq.11): {wall:.2f}s "
          f"(prefill {s.prefill_time:.2f}s, decode {s.decode_time:.2f}s)")
    print(f"throughput(Eq.12): {s.generated_tokens / wall:.1f} tok/s")
    lat = s.latency_summary()
    print(f"TTFT p50/p95    : {lat['ttft_p50_s']:.3f}s / "
          f"{lat['ttft_p95_s']:.3f}s")
    print(f"TPOT p50/p95    : {lat['tpot_p50_s']:.3f}s / "
          f"{lat['tpot_p95_s']:.3f}s")
    return engine


if __name__ == "__main__":
    main()
