"""The port's LM training checkpoints and CLI against the JAX package's:
the npz checkpoints ``utils/checkpoint.py`` writes and reads, bitwise in
both directions, and the ``examples/lm.py`` CLI on the CPU (its contract,
convergence, bf16 with accumulation, remat and experts, generation, save
and resume, and the guards that exit 2 before any work, in the JAX CLI's
words). The training step itself is in ``tests/test_torch_train.py``; the
sequence-parallel and tensor-parallel steps in ``tests/test_torch_lm_tp.py``,
the CLI's sequence-parallel runs in ``tests/test_torch_lm_sp_cli.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import transformer as jtf
from cuda_mpi_gpu_cluster_programming_tpu.utils import checkpoint as jckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import lm
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as ttf
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import checkpoint as tckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

# tests/test_decode.py's top-1 MoE whose capacity drops tokens
MOE_KW = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=64, n_experts=4, capacity_factor=0.5)


def _lm_tree():
    return jtf.init_transformer(jax.random.PRNGKey(2), jtf.TransformerConfig(**MOE_KW))


def test_npz_written_by_the_port_loads_in_the_jax_package_bit_exact(tmp_path):
    params = ttf.lm_params_from_jax(jax.tree.map(np.asarray, _lm_tree()), device="cpu")
    tckpt.save_params_npz(tmp_path / "p.npz", params)
    back = jckpt.load_params_npz(tmp_path / "p.npz")
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(lambda t: 0, params))
    for got, want in zip(jax.tree.leaves(back), tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
        assert np.asarray(got).dtype == np.float32


@pytest.mark.parametrize("with_like", [False, True])
def test_npz_written_by_the_jax_package_loads_in_the_port_bit_exact(tmp_path, with_like):
    jparams = _lm_tree()
    jckpt.save_params_npz(tmp_path / "p.npz", jparams)
    like = ttf.init_transformer(ttf.TransformerConfig(**MOE_KW), generator=torch.Generator().manual_seed(0),
                                device="cpu") if with_like else None
    got = tckpt.load_params_npz(tmp_path / "p.npz", like=like)
    assert isinstance(got["layers"], list) and len(got["layers"]) == 2
    for g, w in zip(tree_leaves(got), jax.tree.leaves(jparams)):
        assert isinstance(g, torch.Tensor) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_npz_errors(tmp_path):
    params = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    tckpt.save_params_npz(tmp_path / "p.npz", params)
    with pytest.raises(KeyError, match="has no leaf 'c'"):
        tckpt.load_params_npz(tmp_path / "p.npz", like={**params, "c": torch.ones(1)})
    (tmp_path / "bad.npz").write_bytes((tmp_path / "p.npz").read_bytes()[:40])
    with pytest.raises(ValueError, match="truncated or corrupt") as got:
        tckpt.load_params_npz(tmp_path / "bad.npz")
    with pytest.raises(ValueError) as want:
        jckpt.load_params_npz(tmp_path / "bad.npz")
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]
    with pytest.raises(TypeError, match="bfloat16"):
        tckpt.save_params_npz(tmp_path / "b.npz", {"a": torch.ones(2, dtype=torch.bfloat16)})
    assert not (tmp_path / "b.npz").exists()


# ------------------------------------------------------------------ the CLI

CLI = ["--device", "cpu", "--steps", "40", "--seq-len", "64", "--batch", "2"]


def _run(capsys, argv):
    rc = lm.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _check_contract(out, attn):
    assert f"--- Byte-LM training [{attn}] (shards=1, L=64, batch=2, layers=2, d=128" in out
    assert "Devices: 1 x cpu (cpu)" in out
    assert "Step 1/40: loss = " in out and "Step 40/40: loss = " in out
    assert "Training completed in " in out and " tok/s)" in out
    assert "-> PASSED" in out.split("Verification: loss ")[1].splitlines()[0]


@pytest.mark.parametrize("attn", ["reference", "flash"])
def test_cli_converges_on_the_cpu(capsys, attn):
    rc, out, _ = _run(capsys, CLI + ["--attn", attn])
    assert rc == 0, out
    _check_contract(out, attn)


def test_cli_bf16_with_accumulation(capsys):
    rc, out, _ = _run(capsys, CLI + ["--attn", "flash", "--compute", "bf16", "--accum-steps", "2"])
    assert rc == 0, out
    _check_contract(out, "flash")
    assert "bf16-mixed, accum=2) ---" in out


def test_cli_remat_and_experts(capsys):
    rc, out, _ = _run(capsys, CLI + ["--attn", "flash", "--remat", "--experts", "2"])
    assert rc == 0, out
    assert "d=128, experts=2, remat) ---" in out and "-> PASSED" in out


def test_cli_generates_the_continuation(capsys):
    rc, out, _ = _run(capsys, CLI + ["--generate", "16"])
    assert rc == 0, out
    assert "Generated 16 tokens: [0, 1, 2, 3, 4, 5, 6, 7, 0, 1, 2, 3, 4, 5, 6, 7]" in out
    assert "Generation continuation: PASSED" in out


def test_cli_save_and_resume(capsys, tmp_path):
    path = tmp_path / "lm.npz"
    rc, out, _ = _run(capsys, CLI + ["--save-params", str(path)])
    assert rc == 0 and f"Saved params to {path}" in out
    saved = tckpt.load_params_npz(path)
    rc, out, _ = _run(capsys, CLI[:2] + ["--steps", "1", "--seq-len", "64", "--batch", "2", "--resume", str(path)])
    assert rc == 0 and f"Resumed params from {path}" in out
    first = float(out.split("Step 1/1: loss = ")[1].split()[0])
    assert first < 1.0  # it starts where the saved run ended
    # the JAX package reads the port's checkpoint
    jsaved = jckpt.load_params_npz(path)
    for a, b in zip(jax.tree.leaves(jsaved), tree_leaves(saved)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cli_resume_mismatches_exit_2(capsys, tmp_path):
    path = tmp_path / "dense.npz"
    cfg = ttf.TINY_LM
    tckpt.save_params_npz(path, ttf.init_transformer(cfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    rc, out, err = _run(capsys, CLI + ["--experts", "2", "--resume", str(path)])
    assert rc == 2 and "does not match this run's config" in err and "router" in err and "Step" not in out
    longer = dataclasses.replace(cfg, max_len=2048)
    tckpt.save_params_npz(path, ttf.init_transformer(longer, generator=torch.Generator().manual_seed(0),
                                                     device="cpu"))
    rc, out, err = _run(capsys, CLI + ["--resume", str(path)])
    assert rc == 2 and "pos: checkpoint (2048, 128) vs config (1024, 128)" in err and "Step" not in out


@pytest.mark.parametrize("argv,words", [
    (["--attn", "ring", "--shards", "0"], "--shards must be >= 1, got 0"),
    (["--attn", "ring", "--shards", "3"], "--attn ring needs --seq-len divisible by --shards (128 % 3 != 0)"),
    (["--attn", "ulysses", "--shards", "8"], "--attn ulysses needs --shards dividing n_heads=4 (got 8)"),
    (["--attn", "ring", "--sp-engine", "flash", "--seq-len", "200"],
     "--sp-engine flash with --attn ring needs the per-shard block (seq-len/shards = 200) to divide by the flash "
     "block (128)"),
    (["--attn", "ulysses", "--sp-engine", "flash", "--shards", "2", "--seq-len", "200"],
     "--sp-engine flash needs --seq-len divisible by 128 (got 200)"),
    (["--pp-stages", "3"], "--pp-stages must divide n_layers=2, got 3"),
    (["--fsdp", "--pp-stages", "2"], "--fsdp is not combinable with --pp-stages"),
    (["--steps", "0"], "--steps must be >= 1, got 0"),
    (["--attn", "flash", "--seq-len", "200"], "--attn flash needs --seq-len divisible by 128 (got 200)"),
    (["--accum-steps", "0"], "--accum-steps must be >= 1, got 0"),
    (["--accum-steps", "3"], "--accum-steps must divide --batch (2 % 3 != 0)"),
    (["--generate", "1020"], "--generate 1020 exceeds max_len 1024 - prompt 16"),
])
def test_cli_guards_exit_2_before_any_work(capsys, monkeypatch, argv, words):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # no device is reached
    rc, out, err = _run(capsys, ["--batch", "2"] + argv)
    assert rc == 2 and words in err and out == ""


def test_cli_guard_words_are_the_jax_clis(capsys):
    """The one-device guards print what the JAX CLI prints."""
    from cuda_mpi_gpu_cluster_programming_tpu.examples import lm as jlm

    for argv in (["--attn", "flash", "--seq-len", "200"], ["--accum-steps", "3", "--batch", "2"],
                 ["--generate", "1020"], ["--steps", "0"], ["--attn", "ring", "--shards", "3"],
                 ["--attn", "ulysses", "--shards", "8"], ["--attn", "ring", "--sp-engine", "flash", "--seq-len", "200"],
                 ["--attn", "ulysses", "--sp-engine", "flash", "--shards", "2", "--seq-len", "200"],
                 ["--pp-stages", "3"], ["--fsdp", "--pp-stages", "2", "--batch", "2"]):
        assert jlm.main(argv) == 2
        want = capsys.readouterr().err
        assert lm.main(argv + ["--device", "cpu"]) == 2
        assert capsys.readouterr().err == want
