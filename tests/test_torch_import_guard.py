"""The port stands alone: no module of ``src/repro_torch`` and no line of
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_package():
    names = {p.name for p in FILES}
    assert {"engine.py", "ops.py", "transformer.py", "chip_smoke.py",
            "mla.py", "moe.py", "deepseek_v2_lite_16b.py",
            "paged_latent_decode.py", "latent_chunk_prefill.py",
            "flash_prefill.py", "frontend.py", "faults.py", "pipeline.py",
            "serve.py", "steps.py", "quickstart.py",
            "serve_continuous_batching.py", "mixtral_8x22b.py",
            "internvl2_2b.py", "sharded.py", "mesh.py", "whisper.py",
            "whisper_small.py", "quant.py", "optimizer.py", "train.py",
            "ckpt.py", "train_small.py", "tree.py"} <= names
