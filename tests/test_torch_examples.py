"""The port's examples on the CPU at their reduced configs:
``repro_torch.examples.quickstart`` (the five technique modes; original,
opt-gqa and opt-pa greedy-identical, as the JAX package's quickstart
states) and ``serve_continuous_batching`` on internvl2-2b-reduced (its
patch stub in every lane)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import serve_continuous_batching  # noqa: E402


def test_quickstart_modes_agree(capsys):
    outs = quickstart.main(["--device", "cpu"])
    assert list(outs) == ["original", "opt-kv", "opt-gqa", "opt-pa", "coopt"]
    assert all(len(o) == 8 for mode in outs.values() for o in mode)
    assert outs["original"] == outs["opt-gqa"] == outs["opt-pa"]
    assert "greedy-identical to original: True" in capsys.readouterr().out


def test_serve_continuous_batching_vlm(capsys):
    eng = serve_continuous_batching.main(
        ["--arch", "internvl2-2b", "--reduced", "--device", "cpu",
         "--requests", "5"])
    out = capsys.readouterr().out
    assert "requests served : 5" in out and "tokens generated: 80" in out
    assert eng.ecfg.max_len == 256 + 16
    assert eng.stats.rejected == 0 and eng.scheduler.extra_tokens == 16
    assert eng.scheduler.manager.pages_in_use == 0
