"""frontend.dispatch_ms: the host's milliseconds per step dispatch
(``AsyncEngine._dispatch_one``: plan, build, copy, graph launch), mean over
the window's dispatches. Moves tpot_p90_ms."""


def read(run):
    spans = run.window_spans("dispatch")
    if not spans:
        return None
    return sum(b - a for a, b in spans) / len(spans) * 1e3
