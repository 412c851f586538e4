"""The sync pass of the port's serving launcher against the JAX package's
on qwen3-4b-reduced: the report's keys in the JAX order, every count and
rate equal. The case and its check are ``tests/test_torch_serve.py``'s;
it is the longest case of that file and lives in a file of its own so
that a ``--dist loadfile`` run puts it in another worker than the rest of
that file."""
import pytest

pytest.importorskip("torch")

from test_torch_serve import check_workload, params  # noqa: E402,F401


@pytest.mark.parametrize("case", ["sync"])
def test_serve_workload_matches_jax(monkeypatch, params, case):  # noqa: F811
    """``check_workload`` for the sync pass."""
    check_workload(monkeypatch, params, case)
