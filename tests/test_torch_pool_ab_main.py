"""The port's pool A/B entry point, ``pool_ab.main``, on the CPU: six rows
a pool and dtype in the schema and strategy order of the JAX package's
``scripts/pool_ab.py`` (read from its file, not imported), exit 1 with a
mismatch or an error row when a strategy is wrong or raises; and the
space-to-depth pool's wrapper: no launch on the CPU, its refusals. The
pools against the JAX script's are in ``tests/test_torch_pool_ab.py``.
"""

import json
import re
from pathlib import Path

import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu_torch import pool_ab
from cuda_mpi_gpu_cluster_programming_tpu_torch.ops import cuda_kernels as ck
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "pool_ab.py"
DTYPES = ("fp32", "bf16")
# the JAX script's strategies, in its order (the keys of its ``strategies`` dict)
JAX_ORDER = tuple(re.findall(r'^\s+"(\w+)": lambda', SCRIPT.read_text(), re.M))
ROW_KEYS = {"strategy", "pool", "batch", "dtype", "ms_per_pass"}


def _run_main(capsys, *argv):
    rc = pool_ab.main(["--device", "cpu", "--batch", "2", *argv])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    return rc, rows


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pool", sorted(pool_ab.POOL_SHAPES))
def test_main_on_the_cpu_prints_six_rows_in_the_jax_schema(pool, dtype, capsys):
    ck.reset_launches()
    rc, rows = _run_main(capsys, "--pool", pool, "--dtype", dtype)
    assert rc == 0
    assert tuple(r["strategy"] for r in rows) == JAX_ORDER
    for r in rows:
        assert set(r) == ROW_KEYS, r
        assert (r["pool"], r["batch"], r["dtype"]) == (pool, 2, dtype)
        assert r["ms_per_pass"] > 0
    assert all(n == 0 for n in ck.LAUNCHES.values())  # the CPU runs no kernel


def test_a_wrong_strategy_exits_1_with_a_mismatch(capsys, monkeypatch):
    real = ck.maxpool_s2d
    monkeypatch.setattr(ck, "maxpool_s2d", lambda x, **kw: real(x, **kw) + 1)
    rc, rows = _run_main(capsys, "--pool", "pool2")
    assert rc == 1
    assert [r["strategy"] for r in rows if r.get("mismatch")] == ["s2d128"]
    assert all(r["mismatch"] is True for r in rows if "mismatch" in r)


def test_a_strategy_that_raises_prints_an_error_row_and_exits_1(capsys, monkeypatch):
    def boom(x, **kw):
        raise RuntimeError("no such kernel")

    monkeypatch.setattr(ck, "maxpool_phases", boom)
    rc, rows = _run_main(capsys, "--pool", "pool2")
    assert rc == 1 and len(rows) == 6
    (err,) = [r for r in rows if "error" in r]
    assert err["strategy"] == "current" and "no such kernel" in err["error"]
    assert set(err) == {"strategy", "pool", "error"}


def test_main_raises_without_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pool_ab.main(["--batch", "2", "--pool", "pool2"])


def test_the_cpu_wrapper_launches_nothing():
    ck.reset_launches()
    x = torch.randn((1, 9, 9, 20))
    ck.maxpool_s2d(x, window=3, stride=2)
    ck.maxpool_s2d_packed(ck.s2d_pool_operand(x, window=3, stride=2), 20, window=3, stride=2)
    assert ck.LAUNCHES["maxpool_s2d"] == 0


def test_bad_operands_raise():
    with pytest.raises(TypeError):
        ck.maxpool_s2d(torch.zeros((1, 9, 9, 4), dtype=torch.float64), window=3, stride=2)
    with pytest.raises(ValueError, match="NHWC"):
        ck.maxpool_s2d(torch.zeros((9, 9, 4)), window=3, stride=2)
    with pytest.raises(ValueError, match="empty output"):
        ck.maxpool_s2d(torch.zeros((1, 2, 2, 4)), window=3, stride=2)
    with pytest.raises(ValueError, match="multiple of 128"):
        ck.maxpool_s2d_packed(torch.zeros((1, 5, 5, 4 * 96)), 96, window=3, stride=2)
    with pytest.raises(ValueError, match="channels"):
        ck.maxpool_s2d_packed(torch.zeros((1, 5, 5, 4 * 128)), 130, window=3, stride=2)
