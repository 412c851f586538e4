"""The port's checkpoints (``repro_torch.checkpoint``): the twins of
``tests/test_checkpoint.py`` (mixed dtypes with bf16 and fp8 leaves, a
structure mismatch, a model's params), and the layout shared with the JAX
package: a port checkpoint of params and ``AdamWState`` loads in
``repro.checkpoint.load_checkpoint`` and the JAX package's loads in the
port, leaf for leaf, bit for bit."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.training import adamw_init as jadamw_init  # noqa: E402
from repro.training import adamw_update as jadamw_update  # noqa: E402

from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.checkpoint import (checkpoint_step,  # noqa: E402
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.training import (AdamWState, adamw_init,  # noqa: E402
                                  adamw_update)

ARCH = "qwen3-4b-reduced"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the suite's parallel workers torch's spinning intra-op pool
    oversubscribes the cores (a 20-step reduced run went from 0.8 s alone
    to 22 s beside two other workers); these small models are as fast on
    one thread, so the module runs torch on one and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    """A leaf's bytes: a torch tensor's or a JAX array's."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def test_roundtrip_mixed_dtypes(tmp_path):
    tree = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
              "d": torch.tensor([1, 2, 3], dtype=torch.int32)},
        "e": (torch.zeros((4,), dtype=torch.float8_e4m3fn),),
    }
    save_checkpoint(str(tmp_path), tree, step=7)
    out = load_checkpoint(str(tmp_path), tree)
    for x, y in zip(tree_util.leaves(tree), tree_util.leaves(out)):
        assert x.dtype == y.dtype
        assert _bits(x) == _bits(y)
    assert checkpoint_step(str(tmp_path)) == 7


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="1 leaves, expected 2"):
        load_checkpoint(str(tmp_path), {"a": torch.zeros(3),
                                        "b": torch.zeros(3)})


def test_model_params_roundtrip(tmp_path):
    p = get_model(get_config(ARCH)).init(0, "cpu")
    save_checkpoint(str(tmp_path), p)
    p2 = load_checkpoint(str(tmp_path), p)
    for x, y in zip(tree_util.leaves(p), tree_util.leaves(p2)):
        assert x.dtype == y.dtype and _bits(x) == _bits(y)


def _trained_state():
    """Converted JAX params of qwen3-4b-reduced after one AdamW step in the
    port (so the moments and step are not zeros), and the JAX trees of the
    same structure."""
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    cfg = get_config(ARCH)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    gen = torch.Generator().manual_seed(0)
    grads = tree_util.tree_map(
        lambda p: torch.randn(p.shape, generator=gen).to(p.dtype), params)
    params, state, _ = adamw_update(params, grads, adamw_init(params))
    return jparams, params, state


def test_port_checkpoint_loads_in_jax(tmp_path):
    """Params and AdamW state saved by the port load in the JAX package,
    every leaf with the port's dtype, shape and bytes, under the JAX
    package's own leaf names."""
    jparams, params, state = _trained_state()
    save_checkpoint(str(tmp_path), {"params": params, "opt": state}, step=1)
    like = {"params": jparams, "opt": jadamw_init(jparams)}
    out = jload(str(tmp_path), like)
    mine = tree_util.leaves({"params": params, "opt": state})
    theirs = jax.tree_util.tree_flatten_with_path(out)[0]
    assert len(mine) == len(theirs)
    for t, (path, j) in zip(mine, theirs):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
        assert _bits(t) == _bits(j), path
    # the file names are the JAX package's for the same tree
    jdir = tmp_path / "jax"
    jsave(str(jdir), like)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        f for f in os.listdir(tmp_path) if f != "jax")


def test_jax_checkpoint_loads_in_port(tmp_path):
    """Params and AdamW state saved by the JAX package (after one JAX step)
    load in the port, leaf for leaf, bit for bit."""
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    jgrads = jax.tree.map(lambda p: jax.random.normal(key, p.shape, p.dtype),
                          jparams)
    jp, jst, _ = jadamw_update(jparams, jgrads, jadamw_init(jparams))
    jsave(str(tmp_path), {"params": jp, "opt": jst}, step=3)
    cfg = get_config(ARCH)
    params = get_model(cfg).init(0, "cpu")
    like = {"params": params, "opt": adamw_init(params)}
    out = load_checkpoint(str(tmp_path), like)
    assert isinstance(out["opt"], AdamWState)
    assert int(out["opt"].step) == 1 and checkpoint_step(str(tmp_path)) == 3
    theirs = jax.tree.leaves({"params": jp, "opt": jst})
    mine = tree_util.leaves(out)
    assert len(mine) == len(theirs)
    for t, j in zip(mine, theirs):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert _bits(t) == _bits(j)
    # and the loaded params run in the port
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with torch.no_grad():
        logits, _ = get_model(cfg).forward(out["params"], batch)
    assert torch.isfinite(logits.float()).all()
