"""device.idle_share: the share of the traced slice in which no kernel, copy
or memset ran on the card (1 - the union of its activities over the
slice's seconds), in %. Moves output_tok_s."""


def read(run):
    tr = run.tracer
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
