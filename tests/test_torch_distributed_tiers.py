"""The AlexNet tiers over ranks (one process a rank, gloo, the CPU) against
the one-process slot path and the JAX package.

Two clusters of 2 ranks, each running every tier once in one launch
(``tests/torch_dist_tiers.py``): at 2 shards (a slot a rank) and at 4 (2
ranks x 2 slots), at ``tests/test_torch_sharded.py``'s ``SMALL`` (43x43,
batch 2; full AlexNet at 99x99): ``v2.1_replicated``, ``v2.2_sharded``,
``v4_hybrid``, ``v5_collective``, ``v7_tp`` and ``v6_full_sharded`` in fp32,
``v5_collective`` in bf16 and int8w. Rank 0's output is bitwise the
one-process slot path's at the same N (the halo rows cross ranks exactly,
and each slot computes what it computes in one process), and within
``precision/gate.py``'s budgets of the JAX package's same tier on the 8
virtual CPU devices (fp32 1e-4 abs and 1e-5 of the max; bf16 2e-2 and
int8w 6e-2 of the max; full AlexNet rtol 2e-5, atol 2e-4 as
``tests/test_alexnet_full.py``). Each rank's collectives are the
one-process counts, and only rank 0 holds the output. At 4 shards conv2's
two-hop halo and pool2's dead shards cross the rank boundary. Then
``run --config v5_collective --shards 4`` under 2 ranks prints the golden
first-10 it prints without them.
"""

import contextlib
import dataclasses
import io
import json
import re

import jax
import numpy as np
import pytest
import torch

import torch_dist_tiers as child
from cuda_mpi_gpu_cluster_programming_tpu import configs as jcfg
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet_full as jfull
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import halo
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import plan as tplan
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.distributed import launch_local
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

RANKS = 2
SHARDS = (2, 4)
BUDGET = {"fp32": (1e-4, 1e-5), "bf16": (np.inf, 2e-2), "int8w": (np.inf, 6e-2)}
GOLDEN_FIRST10 = [29.2932, 25.9153, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255]
CASES = [(n, key, dtype) for n in SHARDS for key, dtype in child.RUNS]


@pytest.fixture(autouse=True)
def _default_variants(monkeypatch):
    for var in ("TPU_FRAMEWORK_FUSE", "TPU_FRAMEWORK_CONV", "TPU_FRAMEWORK_POOL", "TPU_FRAMEWORK_KBLOCK",
                "TPU_FRAMEWORK_ROWBLOCK"):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Each N's cluster run: rank 0's outputs and every rank's counts."""
    got = {}
    for n in SHARDS:
        out = tmp_path_factory.mktemp(f"ranks_n{n}")
        results = launch_local(RANKS, module="tests.torch_dist_tiers", module_args=["--out", str(out), "--shards",
                                                                                    str(n)],
                               device="cpu", backend="gloo", timeout_s=240)
        for r in results:
            assert r.returncode == 0, r.stdout
        with np.load(out / "outputs.npz") as f:
            outs = dict(f)
        got[n] = outs, [json.loads((out / f"rank{i}.json").read_text()) for i in range(RANKS)]
    return got


_ONE = {}


def _one_process(n, key, dtype):
    """The one-process slot path at ``n`` shards: its output and collectives."""
    if (n, key, dtype) not in _ONE:
        full = key == "v6_full_sharded"
        params, x = child.numpy_case()
        fcfg, fparams, fx = child.full_case()
        fwd = tcfg.build_forward(tcfg.REGISTRY[key], fcfg if full else child.SMALL, policy=dtype, device="cpu",
                                 n_shards=n)
        halo.reset_collectives()
        out = fwd(tinit.params_from_jax(fparams if full else params, device="cpu"),
                  torch.from_numpy((fx if full else x).copy()))
        _ONE[(n, key, dtype)] = out.numpy(), dict(halo.COLLECTIVES)
    return _ONE[(n, key, dtype)]


def _jax(n, key, dtype):
    full = key == "v6_full_sharded"
    params, x = child.numpy_case()
    if full:
        fcfg, params, x = child.full_case()
        cfg = jfull.AlexNetConfig(blocks12=dataclasses.replace(jalex.BLOCKS12, in_height=99, in_width=99),
                                  fc6=fcfg.fc6, fc7=fcfg.fc7, num_classes=fcfg.num_classes)
    else:
        cfg = dataclasses.replace(jalex.BLOCKS12, in_height=43, in_width=43)
    fwd = jcfg.build_forward(jcfg.REGISTRY[key], cfg, n_shards=n, policy=dtype)
    return np.asarray(fwd(jax.tree.map(np.asarray, params), x), np.float32)


@pytest.mark.parametrize("n,key,dtype", CASES, ids=[f"n{n}-{k}-{d}" for n, k, d in CASES])
def test_rank0_output_is_the_one_process_slot_paths_bit_for_bit(clusters, n, key, dtype):
    outs, ranks = clusters[n]
    want, collectives = _one_process(n, key, dtype)
    got = outs[f"{key}/{dtype}"]
    assert got.shape == want.shape and np.array_equal(got, want), float(np.max(np.abs(got - want)))
    for rank, counts in enumerate(ranks):
        c = counts[f"{key}/{dtype}"]
        assert c["collectives"] == collectives, (rank, c["collectives"], collectives)
        assert c["output"] == (rank == 0)
        assert c["wire"]["device"] == 0 and c["wire"]["staged"] > 0  # gloo: every byte through host memory


@pytest.mark.parametrize("n,key,dtype", CASES, ids=[f"n{n}-{k}-{d}" for n, k, d in CASES])
def test_rank0_output_is_within_the_gates_budget_of_the_jax_tier(clusters, n, key, dtype):
    got = clusters[n][0][f"{key}/{dtype}"]
    want = _jax(n, key, dtype)
    if key == "v6_full_sharded":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
        return
    max_abs, max_rel = BUDGET[dtype]
    diff = float(np.max(np.abs(got - want)))
    assert diff <= max_abs and diff / float(np.max(np.abs(want))) <= max_rel, (dtype, diff)


def test_at_4_shards_the_two_hop_halo_and_the_dead_shards_cross_ranks():
    """At 43x43 and 4 shards (2 a rank): conv2's top halo reaches 2 slots
    back, so slot 2 (rank 1) takes rows of slot 0 (rank 0); pool2 leaves one
    row, so slots 1-3, two of them on rank 1, own nothing and are masked.
    Both held bitwise above; here the plan says they cross."""
    layers = {lp.name: lp for lp in tplan.make_shard_plan(child.SMALL, 4).layers}
    per = 4 // RANKS
    conv2 = layers["conv2"]
    hops = -(-conv2.h_top // conv2.b_in)
    assert hops == 2 and (2 - hops) // per != 2 // per
    pool2 = layers["pool2"]
    dead = [i for i in range(4) if i * pool2.b_out >= pool2.l_out]
    assert dead == [1, 2, 3] and {i // per for i in dead} == {0, 1}


def test_run_main_over_two_ranks_prints_the_golden_it_prints_alone():
    argv = ["--config", "v5_collective", "--shards", "4", "--device", "cpu", "--batch", "1", "--repeats", "1",
            "--warmup", "1"]
    alone = io.StringIO()
    with contextlib.redirect_stdout(alone):
        assert trun.main(argv) == 0
    first10 = re.search(r"^Final Output \(first 10 values\): (.+)$", alone.getvalue(), re.M).group(1)
    assert np.allclose([float(v) for v in first10.split()], GOLDEN_FIRST10, rtol=2e-5, atol=0)
    r0, r1 = launch_local(RANKS, module="cuda_mpi_gpu_cluster_programming_tpu_torch.run", module_args=argv,
                          device="cpu", timeout_s=240)
    assert r0.returncode == 0 and r1.returncode == 0, (r0.stdout, r1.stdout)
    assert f"Final Output (first 10 values): {first10}\n" in r0.stdout
    assert "Mesh: 4 shards over 2 ranks x 2 slots on cpu (gloo)" in r0.stdout
    assert re.search(r"^Rank 0/2: slots 0-1 of 4 \(gloo\); .*collectives ppermute=6; .*output sha256 \w{64}", r0.stdout,
                     re.M)
    assert "Final Output" not in r1.stdout and "Mesh:" not in r1.stdout
    assert re.search(r"^Rank 1/2: slots 2-3 of 4 \(gloo\); .*output on rank 0", r1.stdout, re.M)
    bad = launch_local(RANKS, module="cuda_mpi_gpu_cluster_programming_tpu_torch.run",
                       module_args=[*argv[:2], "--shards", "3", "--device", "cpu"], device="cpu", timeout_s=240)
    # every rank refuses; the first to exit ends the cluster, so the other may be killed before its own exit 2
    assert all(r.returncode != 0 for r in bad)
    assert any(r.returncode == 2 and "N % R must be 0" in r.stdout for r in bad)
