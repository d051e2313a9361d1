"""The import guard compares whole top-level names, and the reference's
sources import nothing of the program, JAX or the JAX package."""
import subprocess
import sys

from benchmark import guard, harness


def test_top_level_names_compared_whole():
    assert guard.loaded_forbidden(["sparf_tpu_torch", "sparf_tpu_torch.ops.fused_mlp",
                                   "jaxtyping", "flaxen", "torch"]) == []
    assert guard.loaded_forbidden(["sparf_tpu", "sparf_tpu.models.renderer", "jax.numpy",
                                   "jaxlib", "flax.linen"]) == sorted(
        ["sparf_tpu", "sparf_tpu.models.renderer", "jax.numpy", "jaxlib", "flax.linen"])


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert guard.reference_imports() == []
    (tmp_path / "bad.py").write_text("import torch\nfrom sparf_tpu_torch.ops import fused_mlp\n"
                                     "import jax.numpy as jnp\n")
    assert guard.reference_imports(tmp_path) == ["bad.py: sparf_tpu_torch.ops",
                                                 "bad.py: jax.numpy"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The harness, the program's trainer and the reference in a fresh
    interpreter leave no forbidden module behind."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import guard, harness\n"
            "from benchmark.reference import scene, step, nerf\n"
            "from sparf_tpu_torch.training import define_trainer, engine\n"
            "from sparf_tpu_torch.utils import video\n"
            "print(guard.loaded_forbidden())\n") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
