"""kern.decode_attn_roofline: the least time of every decode attention
launch in the traced slice (K2/K4 dense, K5/K7 latent; one a layer a
decode step) over those kernels' summed device time, in %. A launch's
least time is ``roofline.bound`` of its distinct live cached tokens, its
query and output rows, and its operations. Moves tpot_p90_ms."""
from bench_h100.roofline import attention_launch, bound
from bench_h100.trace import DECODE_KERNELS, kernel_us


def read(run):
    tr = run.tracer
    if tr is None:
        return None
    steps = [s for s in run.slice_steps() if s.kind == "decode"]
    t = kernel_us(tr.acts, DECODE_KERNELS) / 1e6
    if not steps or t <= 0:
        return None
    least = sum(bound(*attention_launch(run.shapes, s.q_pos, s.tables,
                                        s.lens, run.page_size))
                for s in steps) * run.shapes.layers
    return 100.0 * least / t
