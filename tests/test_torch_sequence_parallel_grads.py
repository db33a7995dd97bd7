"""Gradients of the port's ring and Ulysses attention against the JAX
package's, on the CPU.

The loss is ``sum(out ** 2)`` of the attention. The JAX package
differentiates its shard_map programs (the ring's flash engine through the
flash kernels' joint ``(out, lse)`` VJP, Ulysses' through the
whole-sequence one; Pallas in interpret mode); the port differentiates its
slots' copies, the LSE merge and the same joint VJP with plain autograd,
over the plain versions of the flash kernels on the CPU.

Tolerance: rtol 1e-4, atol 5e-4, the JAX package's own for the ring's
flash gradients against its oracle (``tests/test_sequence_parallel.py``):
the backward sums the fp32 partials of every hop in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.parallel import sequence_parallel as jsp
from cuda_mpi_gpu_cluster_programming_tpu.parallel.mesh import make_mesh as jmake_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import sequence_parallel as tsp
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh

FNS = {"ring": (jsp.ring_attention, tsp.ring_attention), "ulysses": (jsp.ulysses_attention, tsp.ulysses_attention)}
RTOL, ATOL = 1e-4, 5e-4


def _grads(strategy, shape, seed, jmesh=None, mesh=None, **kw):
    """(JAX grads, port grads) of sum(out ** 2) in q, k and v."""
    jfn, tfn = FNS[strategy]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v, mesh=jmesh, **kw) ** 2), (0, 1, 2)))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = torch.autograd.grad((tfn(*leaves, mesh=mesh, **kw) ** 2).sum(), leaves)
    return want, got


def _close(want, got):
    for w, g in zip(want, got):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_flash_engine_gradients_match_the_jax_package(strategy, n, causal):
    _close(*_grads(strategy, (1, 32, 4, 8), 2, mesh=make_mesh(n, device="cpu"), n_shards=n, causal=causal,
                   engine="flash"))


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_einsum_engine_gradients_match_the_jax_package(strategy):
    _close(*_grads(strategy, (1, 32, 4, 8), 3, mesh=make_mesh(4, device="cpu"), n_shards=4, causal=True,
                   engine="einsum"))


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_flash_gradients_with_head_axis(strategy):
    """The joint VJP composed with tp head groups on a (4, 2) (sp, tp) mesh."""
    jmesh = jmake_mesh(2, axis_name="tp", dp=4, dp_axis_name="sp")
    mesh = make_mesh(2, axis_name="tp", dp=4, dp_axis_name="sp", device="cpu")
    _close(*_grads(strategy, (2, 32, 8, 8), 4, jmesh=jmesh, mesh=mesh, n_shards=4, causal=True, engine="flash",
                   head_axis="tp"))


def test_the_merge_of_an_empty_partial_has_no_nan_gradient():
    """A query that sees only its own key on its diagonal hop (the first row
    of each slot's block), at n = L: every block one row, every hop but the
    diagonal and the earlier ones skipped, the merge starting from the
    finite NEG_INF lse."""
    q, k, v = (torch.randn((1, 4, 2, 8), generator=torch.Generator().manual_seed(s), requires_grad=True)
               for s in range(3))
    out = tsp.ring_attention(q, k, v, n_shards=4, causal=True, engine="flash", mesh=make_mesh(4, device="cpu"))
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    # the first query sees only the first key: its output is v's first row
    torch.testing.assert_close(out[:, 0], v[:, 0].detach(), rtol=0, atol=1e-6)
