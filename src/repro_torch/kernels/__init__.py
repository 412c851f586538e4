"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

K1 ``kv_cache_write``, K2 ``paged_pool_decode``, K3 ``flash_chunk_prefill``,
K4 ``paged_pool_decode_visits``, K5 ``paged_latent_decode``, K6
``latent_chunk_prefill``, K7 ``paged_latent_decode_visits`` and K8
``flash_prefill``; ``cuda`` builds and loads them and counts their
launches, ``ops`` dispatches the engine's cache layout to them.
"""
