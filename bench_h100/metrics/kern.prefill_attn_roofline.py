"""kern.prefill_attn_roofline: the least time of every chunk attention
launch in the traced slice (K3 dense, K6 latent; one a layer a step with
prompt chunks, decode lanes included) over those kernels' summed device
time, in %. Operations count the real query rows against their visible
keys. Moves tpot_p90_ms."""
from bench_h100.roofline import attention_launch, bound
from bench_h100.trace import PREFILL_KERNELS, kernel_us


def read(run):
    tr = run.tracer
    if tr is None:
        return None
    steps = [s for s in run.slice_steps() if s.kind != "decode"]
    t = kernel_us(tr.acts, PREFILL_KERNELS) / 1e6
    if not steps or t <= 0:
        return None
    least = sum(bound(*attention_launch(run.shapes, s.q_pos, s.tables,
                                        s.lens, run.page_size))
                for s in steps) * run.shapes.layers
    return 100.0 * least / t
