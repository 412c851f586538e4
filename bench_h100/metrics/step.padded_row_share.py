"""step.padded_row_share: query rows that write no cache slot (padding:
``slot_idx == -1``) over all query rows of the window's steps, in %.
Moves output_tok_s."""


def read(run):
    steps = run.window_steps()
    rows = sum(s.rows for s in steps)
    if not rows:
        return None
    return 100.0 * sum(s.padded for s in steps) / rows
