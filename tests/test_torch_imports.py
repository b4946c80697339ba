"""The port imports nothing of JAX, flax or the JAX package (an AST scan of
every module of aimnet_x2d_tpu_torch/ and of chip_smoke.py)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "aimnet_x2d_tpu"}
FILES = sorted((ROOT / "aimnet_x2d_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_has_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "aimnet_x2d_tpu_torch/ops/bin_mp.py" in names
    assert "aimnet_x2d_tpu_torch/ops/bin_wpool.py" in names
    for mod in ("ops/bin_attnpool.py", "models/losses.py", "training/trainer.py",
                "training/evaluator.py", "training/schedulers.py", "data/io.py", "runner.py",
                "ops/fused_edge.py", "ops/pallas_segment.py", "ops/segment.py", "ops/halo.py",
                "parallel/halo.py", "parallel/mesh.py", "parallel/multihost.py",
                "parallel/graph_parallel.py", "chem/native.py", "data/native_batch.py",
                "training/predictor.py", "inference/pipeline.py"):
        assert f"aimnet_x2d_tpu_torch/{mod}" in names
    for src in ("mp_stack.cu", "mp_stack_bwd.cu", "attnpool.cu", "wpool.cu", "common.cuh",
                "wgrad.cuh", "fused_edge.cu", "mp_ext.cu"):
        assert (ROOT / "aimnet_x2d_tpu_torch/csrc" / src).exists()


def test_port_has_a_counterpart_of_every_jax_module():
    """Every module of the JAX package has its namesake in the port; the
    port's only modules of its own build the kernels and pick the device."""
    def modules(pkg):
        return {p.relative_to(ROOT / pkg).as_posix() for p in (ROOT / pkg).rglob("*.py")}

    jax_mods, port_mods = modules("aimnet_x2d_tpu"), modules("aimnet_x2d_tpu_torch")
    assert jax_mods - port_mods == set()
    assert port_mods - jax_mods == {"ops/cuda_build.py", "utils/device.py"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"
