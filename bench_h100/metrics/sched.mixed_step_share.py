"""sched.mixed_step_share: of the window's steps that carry decode lanes,
the share that also carry prompt chunks (a mixed step runs every lane at
the chunk's row width), in %. Moves tpot_p90_ms."""


def read(run):
    steps = [s for s in run.window_steps() if s.decode]
    if not steps:
        return None
    return 100.0 * sum(1 for s in steps if s.chunks) / len(steps)
