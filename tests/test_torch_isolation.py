"""The port stands alone: no source file under ``src/repro_torch`` (nor
``chip_smoke.py``) imports ``jax`` or the JAX package ``repro``, and
importing the port loads neither.  Its kernels stand below its core: no
module under ``src/repro_torch/kernels`` imports ``repro_torch.core``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
KERNELS = sorted((PORT / "kernels").rglob("*.py"))


def _imported(path: Path) -> set:
    """The modules ``path`` imports, anywhere in it; a relative import
    resolved against the package of a file under ``src``, with each
    imported name as a possible submodule."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
        elif isinstance(node, ast.ImportFrom) and node.level > 0:
            package = path.relative_to(SRC).parent.parts
            base = ".".join(package[: len(package) - node.level + 1])
            module = f"{base}.{node.module}" if node.module else base
            names.add(module)
            names.update(f"{module}.{a.name}" for a in node.names)
    return names


def test_the_port_has_sources():
    assert len(FILES) >= 17
    assert {"distance_topk.cu", "grouped_distance_topk.cu", "flash_attention.cu", "flash_attention_wgmma.cu"} <= {
        p.name for p in (PORT / "csrc").glob("*.cu")
    }


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(SRC.parent)) for p in FILES])
def test_no_source_imports_jax_or_repro(path):
    bad = {m for m in _imported(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path.relative_to(SRC.parent)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", KERNELS, ids=[str(p.relative_to(SRC.parent)) for p in KERNELS])
def test_no_kernel_module_imports_the_core(path):
    bad = {m for m in _imported(path) if m == "repro_torch.core" or m.startswith("repro_torch.core.")}
    assert not bad, f"{path.relative_to(SRC.parent)} imports {sorted(bad)}"


def test_importing_the_port_loads_neither():
    code = (
        "import sys, repro_torch, repro_torch.core, repro_torch.kernels.distance_topk, "
        "repro_torch.kernels._build, repro_torch.configs.ecpfs_paper, repro_torch.data.synthetic, "
        "repro_torch.models, repro_torch.models.transformer, repro_torch.kernels.flash_attention, "
        "repro_torch.configs.lm_archs, repro_torch.configs.shapes, repro_torch.core.legacy, "
        "repro_torch.launch.serve, repro_torch.launch.train, repro_torch.optim, repro_torch.checkpoint, "
        "repro_torch.distributed, repro_torch.models.gnn, repro_torch.configs, repro_torch.data, "
        "repro_torch.launch.cells, repro_torch.launch.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120,
    )
    assert out.stdout.strip() == ""
