"""sched.prefix_hit_rate: prompt pages served from the prefix cache over
pages looked up, inside the window (``EngineStats.prefix_cache_hits`` /
``prefix_cache_queries``), in %. A hit skips its pages' prefill, so fewer
mixed steps: moves output_tok_s."""


def read(run):
    q = run.stats1["queries"] - run.stats0["queries"]
    if q <= 0:
        return None
    return 100.0 * (run.stats1["hits"] - run.stats0["hits"]) / q
