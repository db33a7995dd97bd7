"""The port stands alone: it imports neither JAX nor the JAX package.

The import check runs in a fresh interpreter, because this test process
already holds jax (tests/conftest.py imports it). The AST scan covers every
module of the port and ``chip_smoke.py``, including imports inside
functions that an import check would not reach.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "cuda_mpi_gpu_cluster_programming_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cuda_mpi_gpu_cluster_programming_tpu")

_PROBE = """
import sys
import cuda_mpi_gpu_cluster_programming_tpu_torch.run as run
import cuda_mpi_gpu_cluster_programming_tpu_torch.configs
import cuda_mpi_gpu_cluster_programming_tpu_torch.ops.kernel_model
import cuda_mpi_gpu_cluster_programming_tpu_torch.observability.trace
import cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.chaos
import cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.sentinel
import cuda_mpi_gpu_cluster_programming_tpu_torch.tuning
assert run.main(["--config", "v3_pallas", "--device", "cpu", "--height", "45", "--width", "45",
                 "--repeats", "1", "--warmup", "1"]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_and_running_the_port_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"
