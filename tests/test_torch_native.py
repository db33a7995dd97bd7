"""The port's native data pipeline (``<port>/native``) against the JAX
package's, on the CPU: the same C++ stream, built from the port's own copy
of ``dataloader.cpp``, gives the same bits."""

import numpy as np
import pytest

from cuda_mpi_gpu_cluster_programming_tpu import native as jnative
from cuda_mpi_gpu_cluster_programming_tpu_torch import native as tnative


@pytest.mark.parametrize("mode", ["ones", "uniform"])
@pytest.mark.parametrize("shape,seed", [((2, 99, 99, 3), 0), ((1, 7, 5, 3), 1), ((3, 4), 2**63 + 5)])
def test_fill_batch_is_the_jax_packages_bit_for_bit(mode, shape, seed):
    got = tnative.fill_batch(shape, mode=mode, seed=seed)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, jnative.fill_batch(shape, mode=mode, seed=seed))
    if mode == "ones":
        assert (got == 1.0).all()
    else:
        np.testing.assert_array_equal(got.reshape(-1)[:512], tnative.lcg_uniform_numpy(seed, 512)[: got.size])
        assert 0.0 <= got.min() and got.max() < 1.0


@pytest.mark.parametrize("depth,workers", [(1, 1), (2, 3), (4, 2)])
def test_loader_batch_k_is_fill_batch_of_its_seed(depth, workers):
    shape, seed = (2, 9, 9, 3), 11
    assert tnative.batch_seed(seed, 4) == jnative.batch_seed(seed, 4)
    with tnative.NativeDataLoader(shape, mode="uniform", seed=seed, depth=depth, workers=workers) as dl:
        batches = [next(dl) for _ in range(6)]
    for k, b in enumerate(batches):
        np.testing.assert_array_equal(b, tnative.fill_batch(shape, "uniform", tnative.batch_seed(seed, k)))
    assert len({b.tobytes() for b in batches}) == 6
    with pytest.raises(ValueError):
        tnative.NativeDataLoader(shape, depth=0)
