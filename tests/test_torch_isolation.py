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

# Every probe imports the port's modules, then runs one entry point at a tiny
# size on the CPU, in a fresh interpreter of its own (its own timeout: a busy
# machine slows one probe, not the others).
_IMPORTS = """
import sys
import torch
import cuda_mpi_gpu_cluster_programming_tpu_torch.run as run
import cuda_mpi_gpu_cluster_programming_tpu_torch.configs
import cuda_mpi_gpu_cluster_programming_tpu_torch.ops.kernel_model
import cuda_mpi_gpu_cluster_programming_tpu_torch.observability.trace
import cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.chaos
import cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.sentinel
import cuda_mpi_gpu_cluster_programming_tpu_torch.tuning
import cuda_mpi_gpu_cluster_programming_tpu_torch.ops.flash_attention
import cuda_mpi_gpu_cluster_programming_tpu_torch.models.transformer as tf
from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import long_context, lm
from cuda_mpi_gpu_cluster_programming_tpu_torch import pool_ab
from cuda_mpi_gpu_cluster_programming_tpu_torch import bench
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import metrics, roofline, stages
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import export, gate, health, replay
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import controller
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import env_info, probe, profiling
"""

_ENTRY_POINTS = {
    "run": """
assert run.main(["--config", "v3_pallas", "--device", "cpu", "--height", "45", "--width", "45",
                 "--repeats", "1", "--warmup", "1"]) == 0
""",
    # the bench's measuring child on the CPU (its parent only adds a subprocess), then run --breakdown,
    # the estimator cut to one pass as for pool_ab
    "bench": """
import time
import cuda_mpi_gpu_cluster_programming_tpu_torch.utils.timing as timing

def one_pass(fn, *args, **_kw):
    t0 = time.perf_counter()
    fn(*args)
    ms = (time.perf_counter() - t0) * 1e3
    return timing.AmortizedStats(samples_ms=[ms], n_chain=1, shadowed=False, total_measured_s=ms / 1e3)

timing.amortized_stats = profiling.amortized_stats = one_pass
bench.CONFIGS, bench.DEVICE, bench.BATCH, bench.REPEATS = ["v1_jit"], "cpu", 1, 1
assert bench._child() == 0
assert run.main(["--config", "v3_pallas", "--device", "cpu", "--height", "45", "--width", "45",
                 "--repeats", "1", "--warmup", "1", "--breakdown"]) == 0
""",
    # the inference service through run --serve, its HTTP front end and client fleet included
    "serve": """
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability import health
from cuda_mpi_gpu_cluster_programming_tpu_torch.serving import frontend, loadgen, server, traffic
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import cuda_graphs
assert run.main(["--config", "v3_pallas", "--serve", "--device", "cpu", "--height", "45", "--width", "45",
                 "--serve-duration", "0.2", "--serve-max-batch", "2", "--serve-frontend", "0"]) == 0
""",
    # the serving controller on a journaled shaped load, a replay of that journal, and the regression gate
    "control": """
import os, tempfile
journal = os.path.join(tempfile.mkdtemp(), "serve.jsonl")
assert run.main(["--config", "v1_jit", "--serve", "--serve-controller", "--traffic-shape", "steady",
                 "--device", "cpu", "--height", "45", "--width", "45", "--serve-duration", "0.2",
                 "--serve-max-batch", "2", "--serve-journal", journal]) == 0
assert run.main(["--serve-replay", journal, "--device", "cpu", "--replay-mult", "2"]) == 0
os.environ["BENCH_GATE_PATHS"] = journal
assert bench._gate_main() == 0
""",
    "long_context": """
assert long_context.main(["--strategy", "flash", "--verify", "--device", "cpu", "--seq-len", "64",
                          "--heads", "2", "--head-dim", "16", "--repeats", "1", "--warmup", "1"]) == 0
""",
    "generate": """
cfg = tf.TransformerConfig(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_len=32, attn_impl="flash")
params = tf.init_transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
assert tf.generate(params, torch.zeros((1, 4), dtype=torch.int64), cfg, steps=2).shape == (1, 6)
""",
    "lm": """
assert lm.main(["--device", "cpu", "--attn", "flash", "--steps", "1", "--seq-len", "16", "--batch", "2",
                "--target-loss", "1000"]) == 0
""",
    # pool_ab.main in full (parse, six strategies, bitwise checks, rows) with its
    # timer cut to one pass: the amortized chains grow without bound under load
    "pool_ab": """
import time
import cuda_mpi_gpu_cluster_programming_tpu_torch.utils.timing as timing

def one_pass(fn, *args, **_kw):
    t0 = time.perf_counter()
    fn(*args)
    return (time.perf_counter() - t0) * 1e3

timing.amortized_ms = one_pass
assert pool_ab.main(["--device", "cpu", "--batch", "1", "--pool", "pool2"]) == 0
""",
}

_REPORT = """
bad = sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_importing_and_running_the_port_loads_no_jax(entry):
    probe = _IMPORTS + _ENTRY_POINTS[entry] + _REPORT.format(forbidden=set(FORBIDDEN))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, cwd=ROOT, timeout=600)
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
