"""step.mfu: useful model FLOPs of the steps in the traced slice (real query
tokens through every projection, their attention over the visible keys,
the LM head of the sampled rows) over the slice's seconds times the bf16
peak, in %. Moves tpot_p90_ms."""
from bench_h100.roofline import BF16_FLOPS, step_model_flops


def read(run):
    tr = run.tracer
    steps = run.slice_steps()
    if tr is None or not steps or tr.window_s <= 0:
        return None
    flops = sum(step_model_flops(run.shapes, s.q_pos, s.sampled)
                for s in steps)
    return 100.0 * flops / (tr.window_s * BF16_FLOPS)
