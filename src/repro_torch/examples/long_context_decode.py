"""Long-context decode with the Opt-KV SkipSet as block sparsity: only the
{sink pages + sliding-window pages} are read per decode step, the paper's
Eq. 5/Eq. 9 machinery used as a sparsity mechanism (streaming-LLM style).

Then the attention-free RWKV-6 path (O(1) state) for contrast.

  python -m repro_torch.examples.long_context_decode                # card
  python -m repro_torch.examples.long_context_decode --device cpu   # CPU

Both run in coopt mode with the hand-written kernels (on CPU tensors their
plain PyTorch versions); rwkv6 runs no kernel.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.coopt import COOPT
from repro_torch.models import get_model


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dense_block_sparse(device, ctx=2048, chunk=512, window=256, steps=8):
    """Prefill ``ctx`` tokens of qwen3-4b-reduced in chunks (absolute
    positions, attention over the paged cache), then decode ``steps``
    tokens with full attention and with the window + sink policy. Returns
    {name: (ms a token, tokens)}."""
    cfg = get_config("qwen3-4b-reduced")
    m = get_model(cfg)
    p = m.init(0, device)
    coopt = COOPT.replace(use_kernel=True)
    cache = m.init_cache(1, ctx + 64, coopt, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, ctx), generator=gen,
                         device=device, dtype=torch.int32)
    for i in range(0, ctx, chunk):
        pos = torch.arange(i, i + chunk, dtype=torch.int32,
                           device=device)[None]
        logits, cache = m.prefill(p, {"tokens": toks[:, i:i + chunk],
                                      "positions": pos, "slot_idx": pos},
                                  cache, coopt)
    print(f"prefilled {int(cache['length'][0])} tokens")
    first = logits.argmax(-1)[:, None].to(torch.int32)
    out = {}
    for name, lw in (("full-attention decode", 0),
                     (f"block-sparse decode (window {window} + sink)",
                      window)):
        c = {k: v.clone() for k, v in cache.items()}
        tok, seq = first, []
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, c = m.decode_step(p, {"token": tok}, c, coopt,
                                  long_window=lw)
            tok = lg.argmax(-1)[:, None].to(torch.int32)
            seq.append(tok)
        _sync(device)
        dt = (time.perf_counter() - t0) / steps * 1e3
        out[name] = (dt, torch.cat(seq, 1)[0].tolist())
        print(f"{name:42s} {dt:7.1f} ms/token")
    return out


def rwkv_constant_state(device, steps=16):
    """Decode ``steps`` tokens of rwkv6-7b-reduced from an empty state.
    Returns (ms a token, the state's bytes, tokens)."""
    cfg = get_config("rwkv6-7b-reduced")
    m = get_model(cfg)
    p = m.init(0, device)
    cache = m.init_cache(1, 0, COOPT, device=device)   # no pages at all
    tok, seq = torch.zeros((1, 1), dtype=torch.int32, device=device), []
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cache = m.decode_step(p, {"token": tok}, cache, COOPT)
        tok = lg.argmax(-1)[:, None].to(torch.int32)
        seq.append(tok)
    _sync(device)
    dt = (time.perf_counter() - t0) / steps * 1e3
    state = sum(v.numel() * v.element_size() for v in cache.values())
    print(f"rwkv6 O(1)-state decode                    {dt:7.1f} ms/token "
          f"(state = {state / 1024:.0f} KiB regardless of context)")
    return dt, state, torch.cat(seq, 1)[0].tolist()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return dense_block_sparse(args.device), rwkv_constant_state(args.device)


if __name__ == "__main__":
    main()
