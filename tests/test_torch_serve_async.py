"""The async and async + packing passes of the port's serving launcher
against the JAX package's on qwen3-4b-reduced: the report's keys in the
JAX order (plus ``graph_pool_gib``), every count and rate equal, and the
async pass's greedy tokens equal or parted only at a near-tie. The cases
and their check are ``tests/test_torch_serve.py``'s; they live in a file
of their own so that a ``--dist loadfile`` run puts them in another worker
than the sync case, the longest of that file."""
import pytest

pytest.importorskip("torch")

from test_torch_serve import check_workload, params  # noqa: E402,F401


@pytest.mark.parametrize("case", ["async", "async_pack"])
def test_serve_workload_matches_jax(monkeypatch, params, case):  # noqa: F811
    """``check_workload`` for the async and the async + packing passes."""
    check_workload(monkeypatch, params, case)
