"""
The port stands alone: neither ``adell_mri_torch`` nor ``chip_smoke.py``
imports JAX, its libraries or anything of the JAX package, and importing
the port's entry point loads no JAX module.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "adell_mri_tpu")
PORT_FILES = sorted((REPO / "adell_mri_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO))
)
def test_port_file_imports_no_jax(path):
    assert path.exists(), path
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import adell_mri_torch\n"
        "import adell_mri_torch.__main__\n"
        "import adell_mri_torch.entrypoints.segmentation.predict\n"
        "import adell_mri_torch.entrypoints.segmentation.train\n"
        "import adell_mri_torch.tools.profile_train\n"
        "import adell_mri_torch.tools.profile_serving\n"
        "import adell_mri_torch.ops.kernels.attention\n"
        "import adell_mri_torch.models.layers.vit\n"
        "import adell_mri_torch.models.segmentation.unetr\n"
        "import adell_mri_torch.interop.from_flax\n"
        "import adell_mri_torch.entrypoints.classification.train\n"
        "import adell_mri_torch.entrypoints.classification.predict\n"
        "import adell_mri_torch.entrypoints.classification_ensemble.train\n"
        "import adell_mri_torch.entrypoints.classification_ensemble.test\n"
        "import adell_mri_torch.entrypoints.classification_ensemble"
        ".predict\n"
        "import adell_mri_torch.entrypoints.prediction_utils\n"
        "import adell_mri_torch.models.layers.gaussian_process\n"
        "import adell_mri_torch.models.layers.conformal\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    run = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert run.returncode == 0, run.stderr[-2000:]
