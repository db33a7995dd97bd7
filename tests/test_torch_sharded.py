"""The port's staged-parallelism tiers against the JAX package's, on the CPU.

The row-sharded (``v2.2_sharded``, ``v4_hybrid``, ``v5_collective``),
replicated (``v2.1_replicated``) and tensor-parallel (``v7_tp``) tiers of
Blocks 1-2, and ``v6_full_sharded``. The port runs on a CPU mesh
(``parallel.mesh.make_mesh(n, device="cpu")``: every slot on the CPU, its
kernel wrappers on their plain versions); the JAX package on the 8 virtual
CPU devices of ``tests/conftest.py``, its Pallas tiers in interpret mode.
Inputs are seeded numpy at ``SMALL`` (43x43, batch 2): pool1 leaves 4 rows,
so at 4 shards conv2's halo takes two hops and pool2's one row leaves three
dead shards.

Tolerances: against JAX, ``precision/gate.py``'s budgets (fp32 1e-4 abs and
1e-5 of the max; bf16 2e-2 and int8w 6e-2 of the max); across shard counts
within the port, rtol = atol = 1e-6 (JAX's ``tests/test_sharded.py``);
full AlexNet, rtol 2e-5 and atol 2e-4 (``tests/test_alexnet_full.py``).
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu import configs as jcfg
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet_full as jfull
from cuda_mpi_gpu_cluster_programming_tpu.parallel import breakdown as jbd
from cuda_mpi_gpu_cluster_programming_tpu.parallel import plan as jplan
from cuda_mpi_gpu_cluster_programming_tpu.precision import gate as jgate
from cuda_mpi_gpu_cluster_programming_tpu_torch import configs as tcfg
from cuda_mpi_gpu_cluster_programming_tpu_torch import native
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet as talex
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import alexnet_full as tfull
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import init as tinit
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import breakdown as tbd
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import halo
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import mesh as tmesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel import plan as tplan
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.sharded import build_sharded_forward
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.tensor_parallel import build_tp_forward
from cuda_mpi_gpu_cluster_programming_tpu_torch.precision import gate as tgate
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal

J_SMALL = dataclasses.replace(jalex.BLOCKS12, in_height=43, in_width=43)
T_SMALL = dataclasses.replace(talex.BLOCKS12, in_height=43, in_width=43)
ROW_TIERS = ("v2.1_replicated", "v2.2_sharded", "v4_hybrid", "v5_collective")
BUDGET = {"fp32": (1e-4, 1e-5), "bf16": (np.inf, 2e-2), "int8w": (np.inf, 6e-2)}
GOLDEN_FIRST10 = [29.2932, 25.9153, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255, 23.3255]


@pytest.fixture(autouse=True)
def _default_variants(monkeypatch):
    for var in ("TPU_FRAMEWORK_FUSE", "TPU_FRAMEWORK_CONV", "TPU_FRAMEWORK_POOL", "TPU_FRAMEWORK_KBLOCK",
                "TPU_FRAMEWORK_ROWBLOCK", "TPU_FRAMEWORK_COMPILE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TPU_FRAMEWORK_COMPILE_CACHE", "0")  # no XLA cache written by these tests


def _numpy_case(seed=20, batch=2, hw=43):
    """Zero-mean weights (so ReLU clamps and the mask's zeros matter), small
    biases and a uniform [0, 1) input, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return ((rng.random(shape, dtype=np.float32) - 0.5) * (4 / fan_in**0.5)).astype(np.float32)

    params = {"conv1": {"w": w(11, 11, 3, 96), "b": ((rng.random(96, dtype=np.float32) - 0.5) * 0.2)},
              "conv2": {"w": w(5, 5, 96, 256), "b": ((rng.random(256, dtype=np.float32) - 0.5) * 0.2)}}
    return params, rng.random((batch, hw, hw, 3), dtype=np.float32)


CASE = _numpy_case()


def _port_args(params, x):
    return tinit.params_from_jax(params, device="cpu"), torch.from_numpy(x.copy())


def _port(key, n, policy="fp32", cfg=T_SMALL, case=CASE):
    fwd = tcfg.build_forward(tcfg.REGISTRY[key], cfg, policy=policy, device="cpu", n_shards=n)
    return fwd(*_port_args(*case)).numpy()


_JAX = {}


def _jax(key, n, policy="fp32", cfg=J_SMALL, case=CASE):
    k = (key, n, policy, cfg)
    if k not in _JAX:
        params, x = case
        fwd = jcfg.build_forward(jcfg.REGISTRY[key], cfg, n_shards=n, policy=policy)
        _JAX[k] = np.asarray(fwd(jax.tree.map(np.asarray, params), x), np.float32)
    return _JAX[k]


def _within(got, want, policy):
    max_abs, max_rel = BUDGET[policy]
    diff = float(np.max(np.abs(got - want)))
    assert diff <= max_abs and diff / float(np.max(np.abs(want))) <= max_rel, (policy, diff)


# ------------------------------------------------------------------ (a) planner


@pytest.mark.parametrize("family", ["blocks12", "alexnet_full"])
def test_shard_plan_is_the_jax_packages_field_for_field(family):
    cfgs = (jalex.BLOCKS12, talex.BLOCKS12) if family == "blocks12" else (jfull.ALEXNET, tfull.ALEXNET)
    for n in range(1, 9):
        want, got = jplan.make_shard_plan(cfgs[0], n), tplan.make_shard_plan(cfgs[1], n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), n
        assert native.make_shard_plan_native(cfgs[1], n) == got
        for lp in got.layers:
            rows = [r for i in range(n) for r in range(*tplan.owned_range(lp.b_out, lp.l_out, i))]
            assert rows == list(range(lp.l_out))
            assert all(native.owned_range_native(lp.b_out, lp.l_out, i) == jplan.owned_range(lp.b_out, lp.l_out, i)
                       for i in range(n + 1))
    assert native.conv_out_dim(227, 11, 0, 4) == 55 and native.pool_out_dim(55, 3, 2) == 27
    with pytest.raises(ValueError, match="n_shards"):
        tplan.make_shard_plan(talex.BLOCKS12, 0)
    with pytest.raises(ValueError, match="degenerate"):
        native.make_shard_plan_native(dataclasses.replace(talex.BLOCKS12, in_height=9, in_width=9), 2)


def test_mesh_places_slots_round_robin_and_says_so(monkeypatch):
    m = tmesh.make_mesh(4, device="cpu")
    assert m.describe() == "4 shards on 1 device: cpu" and m.n_shards == 4 and m.shape == (4,)
    assert tmesh.make_mesh(1, device="cpu").describe() == "1 shard on 1 device: cpu"
    two = tmesh.make_mesh(3, devices=["cpu", "meta"])
    assert [str(d) for d in two.devices] == ["cpu", "meta", "cpu"] and two.describe().endswith("2 devices: cpu, meta")
    assert tmesh.make_mesh(2, dp=2, device="cpu").shape == (2, 2)
    assert tmesh.device_count("cpu") == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcfg.build_forward(tcfg.REGISTRY["v5_collective"], n_shards=2)


# --------------------------------------------------------- (b) against JAX


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("key", ROW_TIERS)
def test_row_tiers_match_jax_fp32(key, n):
    if tcfg.REGISTRY[key].tier == "kernels" and n == 2:
        want = _jax("v2.2_sharded", n)  # JAX's Pallas tiers run in interpret mode at n = 1 and 4 only
    else:
        want = _jax(key, n)
    got = _port(key, n)
    assert got.shape == want.shape == (2, 1, 1, 256)
    _within(got, want, "fp32")


@pytest.mark.parametrize("policy", ["bf16", "int8w"])
@pytest.mark.parametrize("key", ROW_TIERS)
def test_row_tiers_match_jax_low_precision(key, policy):
    """At 2 shards; JAX's Pallas tiers are held to its reference tier of the
    same strategy (``v2.2_sharded``), the same policy."""
    jkey = key if tcfg.REGISTRY[key].tier == "reference" else "v2.2_sharded"
    _within(_port(key, 2, policy), _jax(jkey, 2, policy), policy)
    _within(_port(key, 2, policy), _jax("v1_jit", 1, "fp32"), policy)  # the fp32 oracle's budget too


def test_v4_v5_kernels_tier_take_jax_variants_and_a_plan(monkeypatch):
    """Variants resolve at build time, ``fuse`` is ignored, and every conv
    variant gives the default's value on the CPU."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.ops.variants import KernelVariants

    base = _port("v5_collective", 4)
    for conv in ("taps", "pairs", "fused", "g8"):
        monkeypatch.setenv("TPU_FRAMEWORK_CONV", conv)
        np.testing.assert_allclose(_port("v5_collective", 4), base, rtol=1e-6, atol=1e-6)
    monkeypatch.setenv("TPU_FRAMEWORK_FUSE", "block")
    monkeypatch.setenv("TPU_FRAMEWORK_POOL", "phases")
    fwd = tcfg.build_forward(tcfg.REGISTRY["v4_hybrid"], T_SMALL, device="cpu", n_shards=3)
    monkeypatch.delenv("TPU_FRAMEWORK_POOL")
    np.testing.assert_allclose(fwd(*_port_args(*CASE)).numpy(), base, rtol=1e-6, atol=1e-6)
    got = build_sharded_forward(T_SMALL, 2, tier="kernels", variants=KernelVariants(k_block=64), device="cpu")(
        *_port_args(*CASE))
    np.testing.assert_allclose(got.numpy(), base, rtol=1e-6, atol=1e-6)
    # the sentinel's taps ride beside the output and move none of its bits
    out, digs = build_sharded_forward(T_SMALL, 2, tier="kernels", with_digests=True, device="cpu")(
        *_port_args(*CASE))
    assert np.array_equal(out.numpy(), _port("v5_collective", 2))
    assert sorted(digs) == ["conv1", "conv2", "lrn2", "pool1", "pool2"]
    assert all(d.shape == (2,) and d.dtype == torch.float32 for d in digs.values())


@pytest.mark.parametrize("strategy", ["halo", "tp"])
def test_digest_taps_match_the_jax_packages(strategy):
    """``with_digests=True``: the port's per-stage, per-shard digests are
    the JAX package's (``tree_digest`` inside its ``shard_map`` body)
    within 1e-6 of each, at 2 shards on the reference tier."""
    from cuda_mpi_gpu_cluster_programming_tpu.parallel.sharded import build_sharded_forward as jbuild
    from cuda_mpi_gpu_cluster_programming_tpu.parallel.tensor_parallel import build_tp_forward as jtp

    params, x = CASE
    if strategy == "halo":
        jout, jdigs = jbuild(J_SMALL, 2, with_digests=True)(jax.tree.map(np.asarray, params), x)
        out, digs = build_sharded_forward(T_SMALL, 2, with_digests=True, device="cpu")(*_port_args(*CASE))
    else:
        jout, jdigs = jtp(J_SMALL, 2, with_digests=True)(jax.tree.map(np.asarray, params), x)
        out, digs = build_tp_forward(T_SMALL, 2, with_digests=True, device="cpu")(*_port_args(*CASE))
    _within(out.numpy(), np.asarray(jout), "fp32")
    assert sorted(digs) == sorted(jdigs) == ["conv1", "conv2", "lrn2", "pool1", "pool2"]
    for name, want in jdigs.items():
        want = np.asarray(want, np.float64)
        np.testing.assert_allclose(digs[name].double().numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


# --------------------------------------------------- (c) across shard counts


@pytest.mark.parametrize("key", ROW_TIERS + ("v7_tp",))
def test_every_shard_count_matches_one_shard(key):
    one = _port(key, 1)
    for n in (2, 3, 4) if key != "v7_tp" else (2, 4):  # 256 channels do not split 3 ways
        np.testing.assert_allclose(_port(key, n), one, rtol=1e-6, atol=1e-6)


def test_multi_hop_halos_and_dead_shards_at_eight_shards():
    """8 shards at 43x43: conv2's 4 input rows leave half the shards empty,
    its halo takes two hops, and pool2's one output row is owned by shard 0."""
    plan = tplan.make_shard_plan(T_SMALL, 8)
    conv2 = plan.layers[2]
    assert conv2.b_in == 1 and -(-conv2.h_top // conv2.b_in) == 2
    np.testing.assert_allclose(_port("v5_collective", 8), _port("v5_collective", 1), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_port("v4_hybrid", 8), _jax("v4_hybrid", 1), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ (d) v7_tp


@pytest.mark.parametrize("n", [1, 2, 4])
def test_v7_tp_matches_jax(n):
    _within(_port("v7_tp", n), _jax("v7_tp", n), "fp32")


def test_v7_tp_refuses_what_jax_refuses():
    narrow = dataclasses.replace(talex.BLOCKS12, conv2=talex.ConvSpec(8, 5, 1, 2))
    jnarrow = dataclasses.replace(jalex.BLOCKS12, conv2=jalex.ConvSpec(8, 5, 1, 2))
    for cfg, jc, n, words in ((talex.BLOCKS12, jalex.BLOCKS12, 3, "not divisible"), (narrow, jnarrow, 8, "multi-hop")):
        with pytest.raises(ValueError, match=words):
            build_tp_forward(cfg, n, device="cpu")
        with pytest.raises(ValueError, match=words):
            jcfg.build_forward(jcfg.REGISTRY["v7_tp"], jc, n_shards=n)
    with pytest.raises(ValueError, match="filter slices would not line up"):
        build_tp_forward(T_SMALL, 2, mesh=tmesh.make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="int8w.*tensor-parallel"):
        tcfg.build_forward(tcfg.REGISTRY["v7_tp"], T_SMALL, policy="int8w", device="cpu", n_shards=2)


# ------------------------------------------------------- (e) v6_full_sharded


def test_v6_full_sharded_matches_jax_at_99():
    j_cfg = jfull.AlexNetConfig(blocks12=dataclasses.replace(jalex.BLOCKS12, in_height=99, in_width=99),
                                fc6=64, fc7=32, num_classes=10)
    t_cfg = tfull.AlexNetConfig(blocks12=dataclasses.replace(talex.BLOCKS12, in_height=99, in_width=99),
                                fc6=64, fc7=32, num_classes=10)
    params = jfull.init_full_random(jax.random.PRNGKey(4), j_cfg)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, 99, 99, 3)))
    want = np.asarray(jcfg.build_forward(jcfg.REGISTRY["v6_full_sharded"], j_cfg, n_shards=2)(params, x))
    tp, tx = tinit.params_from_jax(params, device="cpu"), torch.from_numpy(x.copy())
    got = tcfg.build_forward(tcfg.REGISTRY["v6_full_sharded"], t_cfg, device="cpu", n_shards=2)(tp, tx).numpy()
    assert got.shape == want.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-4)
    single = tcfg.build_forward(tcfg.REGISTRY["v6_full_jit"], t_cfg, device="cpu")(tp, tx).numpy()
    np.testing.assert_allclose(got, single, rtol=2e-5, atol=2e-4)
    with pytest.raises(ValueError, match="Blocks 1-2"):
        tcfg.build_forward(tcfg.REGISTRY["v6_full_sharded"], t_cfg, policy="int8w", device="cpu", n_shards=2)


# ---------------------------------------------- (f) collectives and tables


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_collectives_run_are_the_plans(n):
    params, x = _port_args(*CASE)
    for key in ("v2.2_sharded", "v5_collective", "v4_hybrid"):
        staged = key == "v4_hybrid"
        fwd = tcfg.build_forward(tcfg.REGISTRY[key], T_SMALL, device="cpu", n_shards=n)
        halo.reset_collectives()
        fwd(params, x)
        want = jbd.expected_collectives(J_SMALL, n, staged=staged)
        assert sum(halo.COLLECTIVES.values()) == want == tbd.expected_collectives(T_SMALL, n, staged=staged)
        assert halo.COLLECTIVES["ppermute" if staged else "all_gather"] == 0
    if talex.BLOCKS12.conv2.out_channels % n == 0:
        halo.reset_collectives()
        tcfg.build_forward(tcfg.REGISTRY["v7_tp"], T_SMALL, device="cpu", n_shards=n)(params, x)
        want = jbd.expected_tp_collectives(J_SMALL, n)
        assert want == tbd.expected_tp_collectives(T_SMALL, n)
        # every other collective (the LM's all_to_all and psum among them) ran 0 times
        assert halo.COLLECTIVES == {**dict.fromkeys(halo.COLLECTIVES, 0), **want}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_breakdown_tables_are_the_jax_packages(n):
    for staged in (False, True):
        for batch, nbytes in ((1, 4), (8, 2)):
            want = jbd.comm_compute_breakdown(jalex.BLOCKS12, n, batch=batch, dtype_bytes=nbytes, staged=staged)
            got = tbd.comm_compute_breakdown(talex.BLOCKS12, n, batch=batch, dtype_bytes=nbytes, staged=staged)
            assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
            assert tbd.format_table(got, staged=staged) == jbd.format_table(want, staged=staged)
    want = jbd.tp_comm_compute_breakdown(jalex.BLOCKS12, n, batch=2)
    got = tbd.tp_comm_compute_breakdown(talex.BLOCKS12, n, batch=2)
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    assert tbd.format_table(got, transport="x") == jbd.format_table(want, transport="x")
    assert [r.intensity for r in got] == [r.intensity for r in want]


# --------------------------------------------------------- (g) screen_sharded


@pytest.mark.parametrize("policy", ["fp32", "bf16", "int8w"])
def test_screen_sharded_passes_and_fails_as_jax_does(policy, tmp_path):
    params, x = CASE
    tparams, tx = _port_args(params, x)
    tight = {policy: {"*": tgate.StageBudget(max_abs=1e-12, max_rel=1e-12)}}
    jtight = {policy: {"*": jgate.StageBudget(max_abs=1e-12, max_rel=1e-12)}}
    for budgets, jbudgets in ((None, None), (tight, jtight)):
        journal = Journal(tmp_path / f"gate_{budgets is None}.jsonl")
        got = tgate.ToleranceGate(budgets=budgets, journal=journal, preflight=budgets is None).screen_sharded(
            policy, tparams, tx, T_SMALL, n_shards=4, tier="kernels", staged=True)
        want = jgate.ToleranceGate(budgets=jbudgets, preflight=False).screen_sharded(
            policy, jax.tree.map(np.asarray, params), x, J_SMALL, n_shards=4, tier="pallas", staged=True)
        assert got.passed == want.passed == (budgets is None)
        assert [s.stage for s in got.stages] == [s.stage for s in want.stages] == ["lrn2@n4"]
        journal.close()
        (rec,) = Journal.load(journal.path)
        assert rec["key"] == f"gate-sharded:{policy}|n4" and rec["kind"] == ("gate_pass" if got.passed else "gate_fail")


# ------------------------------------------------------------------ (h) CLI


@pytest.fixture
def one_pass(monkeypatch):
    """The CLI's estimator and its ``--breakdown`` timer cut to one timed
    call: these tests read the contract, not the time (an amortized chain
    grows without bound on a loaded CPU)."""
    from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import profiling as tprof
    from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import timing as ttiming

    def timer(fn, *args, **_kw):
        fn(*args)
        return ttiming.AmortizedStats(samples_ms=[1.0], n_chain=1, shadowed=False, total_measured_s=1e-3)

    monkeypatch.setattr(ttiming, "amortized_stats", timer)
    monkeypatch.setattr(tprof, "amortized_stats", timer)


def _first10(out):
    return [float(v) for v in re.search(r"^Final Output \(first 10 values\): (.+)$", out, re.M).group(1).split()]


@pytest.mark.parametrize("key,n", [("v2.2_sharded", 2), ("v5_collective", 4), ("v2.1_replicated", 2), ("v7_tp", 2)])
def test_run_shards_prints_the_contract_and_the_golden(key, n, capsys, one_pass):
    rc = trun.main(["--config", key, "--shards", str(n), "--batch", "1", "--device", "cpu", "--repeats", "1",
                    "--warmup", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"Mesh: {n} shards on 1 device: cpu" in out and "Final Output Shape: 13x13x256" in out
    for line in ("Precision: dtype=fp32", "Compile time:", "Forward Pass completed in", "Timing stats:",
                 "Kernel launches:"):
        assert line in out
    np.testing.assert_allclose(_first10(out), GOLDEN_FIRST10, atol=2e-4)


@pytest.mark.parametrize("key,transport", [("v2.2_sharded", "halo"), ("v4_hybrid", "staged"), ("v7_tp", "tp")])
def test_run_breakdown_prints_the_jax_packages_table(key, transport, capsys, one_pass):
    rc = trun.main(["--config", key, "--shards", "2", "--batch", "2", "--device", "cpu", "--height", "43",
                    "--width", "43", "--repeats", "1", "--warmup", "1", "--breakdown"])
    out = capsys.readouterr().out
    assert rc == 0, out
    if transport == "tp":
        table = jbd.format_table(jbd.tp_comm_compute_breakdown(J_SMALL, 2, batch=2),
                                 transport="all_gather + channel-halo ppermute")
    else:
        table = jbd.format_table(jbd.comm_compute_breakdown(J_SMALL, 2, batch=2, staged=transport == "staged"),
                                 staged=transport == "staged")
    assert table in out and re.search(r"^Layer conv1\S* completed in", out, re.M)


def test_run_single_config_ignores_shards_as_jax_does(capsys, one_pass):
    rc = trun.main(["--config", "v1_jit", "--shards", "2", "--batch", "1", "--device", "cpu", "--height", "43",
                    "--width", "43", "--repeats", "1", "--warmup", "1"])
    out = capsys.readouterr().out
    assert rc == 0 and "Mesh: none (v1_jit runs on one device; --shards 2 does not apply)" in out
    assert trun.main(["--config", "v7_tp", "--shards", "3", "--device", "cpu"]) == 2
    assert "not divisible" in capsys.readouterr().err


def test_the_bench_measures_a_sharded_key_at_one_shard(monkeypatch):
    """The bench's measure mode takes the sharded keys as the JAX bench
    does: built with no shard count, so at one shard."""
    import json

    from cuda_mpi_gpu_cluster_programming_tpu_torch import bench as tbench
    from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import timing as ttiming

    def one_pass(fn, *args, **_kw):
        fn(*args)
        return ttiming.AmortizedStats(samples_ms=[1.0], n_chain=1, shadowed=False, total_measured_s=1e-3)

    out = []
    for name, value in dict(CONFIG="v5_collective", CONFIGS=["v5_collective", "v7_tp"], BATCH=1, REPEATS=1,
                            COMPUTE="fp32", DTYPE="fp32", PLAN_PATH="", DEVICE="cpu").items():
        monkeypatch.setattr(tbench, name, value)
    monkeypatch.setenv("BENCH_BREAKDOWN_REPEATS", "1")
    monkeypatch.delenv("BENCH_CONTINUITY_BATCH", raising=False)
    monkeypatch.setattr(ttiming, "amortized_stats", one_pass)
    monkeypatch.setattr("builtins.print", lambda *a, **kw: out.append(" ".join(str(v) for v in a)))
    assert tbench._child() == 0
    rows = {r["config"]: r for r in (json.loads(line) for line in out if line.startswith("{"))}
    assert set(rows) == {"v5_collective", "v7_tp"}
    assert all("error" not in r and r["value"] > 0 for r in rows.values()), rows
