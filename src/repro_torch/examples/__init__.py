"""Examples of the port, run as ``python -m repro_torch.examples.<name>``:
``quickstart`` (the five technique modes on the same prompts, a greedy
agreement canary) and ``serve_continuous_batching`` (a ShareGPT mix through
the continuous-batching engine, with the paper's Eq. 11/12 metrics)."""
