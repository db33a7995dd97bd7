"""``examples/matmul.py`` in the port, against the JAX package's, on the CPU.

The argument contract (``validate_n``'s words and clamp), every strategy at
1, 2 and 4 shard slots bitwise ``mat_mult_serial`` and bitwise the JAX
package's ``mat_mult_distributed`` on its 8 CPU devices for the same
integer operands (made with numpy from a seed; the port's ``init_data``
draws from a ``torch.Generator``, JAX's PRNG is not reproduced), the ring's
hand-offs counted, and ``main``'s stdout lines against the JAX CLI's.

Tolerance: exact. The operands are integers 0-9, so for n <= 4096 every
product and partial sum is an integer below 2^24, exact in fp32 in any
order; ``check_result``'s 1e-6 (template.c:222) is the reference's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.examples import matmul as jmm
from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import matmul
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import halo
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

N = 64


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(0)
    return rng.integers(0, 10, (N, N)).astype(np.float32), rng.integers(0, 10, (N, N)).astype(np.float32)


@pytest.mark.parametrize("n,shards", [(64, 4), (48, 1), (0, 1), (8192, 4), (8192, 3), (64, 3)])
def test_validate_n_is_the_jax_packages(n, shards):
    try:
        want = jmm.validate_n(n, shards)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            matmul.validate_n(n, shards)
        assert str(got.value) == str(e)
    else:
        assert matmul.validate_n(n, shards) == want


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("strategy", ["scatter", "collective", "ring"])
def test_every_strategy_is_bitwise_the_serial_product_and_the_jax_packages(operands, strategy, shards):
    a, b = operands
    want = np.asarray(jmm.mat_mult_distributed(jnp.asarray(a), jnp.asarray(b), shards, strategy))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    halo.reset_collectives()
    got = matmul.mat_mult_distributed(ta, tb, shards, strategy, make_mesh(shards, device="cpu"))
    assert halo.COLLECTIVES["ppermute"] == (shards if strategy == "ring" else 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, matmul.mat_mult_serial(ta, tb))
    assert not matmul.check_result(got, matmul.mat_mult_serial(ta, tb))


def test_init_data_and_check_result():
    a = matmul.init_data(torch.Generator().manual_seed(0), 32, device="cpu")
    assert a.dtype == torch.float32 and a.shape == (32, 32)
    assert float(a.min()) >= 0 and float(a.max()) <= 9 and torch.equal(a, a.round())
    assert torch.equal(a, matmul.init_data(torch.Generator().manual_seed(0), 32, device="cpu"))
    assert matmul.check_result(a, a + 1e-5) and not matmul.check_result(a, a + 1e-7)
    with pytest.raises(ValueError) as got:
        matmul.mat_mult_distributed(a, a, 1, "gather")
    with pytest.raises(ValueError) as want:
        jmm.mat_mult_distributed(jnp.asarray(a.numpy()), jnp.asarray(a.numpy()), 1, "gather")
    assert str(got.value) == str(want.value)


def _lines(text):
    """stdout with every timing in seconds replaced by one token."""
    return re.sub(r"[0-9]+\.[0-9]+ seconds", "T seconds", text).splitlines()


@pytest.mark.parametrize("argv", [["128", "--shards", "4", "--strategy", "ring"], ["64", "--shards", "2"],
                                  ["64", "--shards", "3"], ["48"], ["8192", "--shards", "3"]])
def test_main_prints_the_jax_clis_lines(capsys, argv):
    want_rc = jmm.main(argv)
    want = _lines(capsys.readouterr().out)
    assert matmul.main(argv + ["--device", "cpu"]) == want_rc
    assert _lines(capsys.readouterr().out) == want
    if want_rc == 0:
        assert "pid=0: Test: PASSED" in want
