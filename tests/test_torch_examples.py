"""The port's examples on the CPU at their reduced configs:
``repro_torch.examples.quickstart`` (the five technique modes; original,
opt-gqa and opt-pa greedy-identical, as the JAX package's quickstart
states), ``serve_continuous_batching`` on internvl2-2b-reduced (its
patch stub in every lane) and ``long_context_decode`` (the dense
block-sparse decode, then rwkv6's O(1) state)."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import long_context_decode  # noqa: E402
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


def test_long_context_decode(capsys):
    """512 tokens prefilled in chunks of 256 (the example's 2048 in chunks
    of 512 take minutes under parallel test workers); full-attention and
    window-128 + sink decodes of 8 tokens each (their tokens may part: the
    window drops keys); rwkv6's state is the same size whatever the
    context: 2 layers x (4 x 64 x 64 f32 + 2 x 256 bf16) + the lane's
    length."""
    dense = long_context_decode.dense_block_sparse("cpu", ctx=512, chunk=256,
                                                   window=128)
    ms, state, toks = long_context_decode.rwkv_constant_state("cpu")
    assert "prefilled 512 tokens" in capsys.readouterr().out
    assert len(dense) == 2
    assert all(len(t) == 8 and ms_ > 0 for ms_, t in dense.values())
    assert state == 2 * (4 * 64 * 64 * 4 + 2 * 256 * 2) + 4
    assert len(toks) == 16 and ms > 0
