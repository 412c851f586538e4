"""The port's serving launcher on page-range shards against the JAX
package's, on qwen3-4b-reduced: the report of ``serve_workload`` with
``num_shards=4``, host placement alone and on a 4-shard mesh. Apart from
``tests/test_torch_serve.py`` (whose weights, settings and key list it
shares), so a ``--dist loadfile`` run puts these two long cases on a worker
of their own."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_serve import ARCH, EQUAL, KW  # noqa: E402


@pytest.fixture(scope="module")
def params():
    jparams = jget_model(jget_config(ARCH)).init(jax.random.PRNGKey(0))
    return params_from_numpy(get_config(ARCH),
                             jax.tree.map(np.asarray, jparams), "cpu")


# page-range shards: 4 shards of a 16-page pool (4, 4, 4 and 3 usable)
SHARD_KW = dict(KW, pool_pages=16, num_shards=4)


@pytest.fixture(scope="module")
def want():
    """The JAX package's report, computed once for both cases."""
    return jserve.serve_workload(ARCH, "coopt", **SHARD_KW)


@pytest.mark.parametrize("mesh", [False, True], ids=["shards", "mesh"])
def test_serve_workload_sharded_matches_jax(params, want, mesh):
    """``--shards 4`` (host placement) and ``--mesh`` (the 4-shard mesh:
    each page range a pool of its own, written per shard, the kernels'
    plain versions reading each shard's pool and merging) report the JAX
    package's keys, and its counts, with ``num_shards=4``: the per-shard
    peaks, preemptions and placements included."""
    from repro_torch.launch.mesh import make_sim_mesh
    got = serve.serve_workload(
        ARCH, "coopt", use_kernel=True, device="cpu", params=params,
        mesh=make_sim_mesh(data=4, model=1, devices=["cpu"] * 4)
        if mesh else None, **SHARD_KW)
    assert list(got) == list(want)
    for k in EQUAL:
        if k in want:
            assert got[k] == want[k], k
    assert got["kv_shards"] == 4 and len(got["shard_peak_utilization"]) == 4
    assert got["placement_prefix_hits"] > 0
