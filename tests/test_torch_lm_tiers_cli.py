"""The ``examples/lm.py`` CLI with the LM's pipeline, FSDP and expert tiers on the CPU.

``--pp-stages 2``, ``--fsdp --fake-devices 4`` (alone, and on a (dp, sp)
mesh with ``--attn ring --sp-engine flash``) and ``--experts 4
--fake-devices 4``, each an in-process ``main()`` call: every run must
converge (the loss under the CLI's 1.0 target) and continue the pattern,
as the JAX CLI's runs do (``tests/test_lm_example.py``), with the JAX
CLI's banner extras and a ``Mesh:`` line. ``--fake-devices N`` sizes the
fsdp and ep tiers as the JAX CLI's device count does. Every pp and fsdp
guard prints the JAX CLI's words with rc 2 before any work (the JAX
package's CLI sees its 8 CPU devices here, so the port's runs are given
``--fake-devices 8``); ``--save-params`` writes whole leaves that the JAX
package's checkpoint loader reads. A file of its own, so these runs do not
lengthen ``tests/test_torch_train_cli.py``'s worker.
"""

import jax
import numpy as np
import pytest

from cuda_mpi_gpu_cluster_programming_tpu.examples import lm as jlm
from cuda_mpi_gpu_cluster_programming_tpu.models.transformer import TINY_LM as JTINY
from cuda_mpi_gpu_cluster_programming_tpu.models.transformer import init_transformer as jinit
from cuda_mpi_gpu_cluster_programming_tpu.utils import checkpoint as jckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import lm
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)

BASE = ["--device", "cpu", "--steps", "8", "--seq-len", "32", "--generate", "8"]


@pytest.mark.parametrize("flags,banner,mesh", [
    (["--pp-stages", "2", "--batch", "2"], ", pp=2x2mb)", "Mesh: 2 shards on 1 device: cpu"),
    (["--fsdp", "--fake-devices", "4", "--batch", "4"], ", fsdp over 4 devices (100% of param bytes sharded))",
     "Mesh: 4 shards on 1 device: cpu"),
    (["--fsdp", "--fake-devices", "4", "--batch", "4", "--attn", "ring", "--sp-engine", "flash", "--shards", "2"],
     ", fsdp (dp=2) x sp=2 (100% of param bytes sharded))",
     "Mesh: 2 shards x 2 data-parallel replicas on 1 device: cpu"),
    (["--experts", "4", "--fake-devices", "4", "--batch", "2"], ", experts=4, ep-sharded over 4 devices)",
     "Mesh: 4 shards on 1 device: cpu"),
], ids=["pp", "fsdp", "fsdp_ring_flash", "ep"])
def test_cli_trains_with_each_tier(capsys, flags, banner, mesh):
    rc = lm.main(BASE + flags)
    out = capsys.readouterr().out
    assert rc == 0, out
    assert banner in out.splitlines()[0] and mesh in out
    assert "-> PASSED" in out.split("Verification: loss ")[1].splitlines()[0]
    assert "Generation continuation: PASSED" in out


def test_experts_run_whole_when_the_slots_do_not_divide_them(capsys):
    """``--experts 3`` over 4 slots (and any count on one device): the JAX
    CLI's replicated MoE, no ep note, no ep mesh."""
    assert lm.main(BASE + ["--experts", "3", "--fake-devices", "4", "--batch", "2", "--steps", "1",
                           "--target-loss", "1e9", "--generate", "0"]) == 0
    out = capsys.readouterr().out
    assert ", experts=3)" in out.splitlines()[0] and "ep-sharded" not in out and "Mesh:" not in out


@pytest.mark.parametrize("argv", [
    ["--pp-stages", "3"],
    ["--pp-stages", "2", "--microbatches", "3"],
    ["--pp-stages", "2", "--microbatches", "0"],
    ["--pp-stages", "2", "--accum-steps", "2", "--microbatches", "4"],
    ["--fsdp", "--pp-stages", "2"],
    ["--fsdp", "--experts", "8"],
    ["--fsdp", "--batch", "3"],
    ["--fsdp", "--attn", "ring", "--shards", "3", "--seq-len", "129"],
    ["--fsdp", "--attn", "ulysses", "--shards", "4", "--batch", "3"],
    ["--pp-stages", "2", "--batch", "3"],
])
def test_tier_guards_print_the_jax_clis_words(capsys, argv):
    """Each guard exits 2 before any work with the JAX CLI's words (the JAX
    CLI here has 8 devices, the port's run ``--fake-devices 8`` slots)."""
    assert jlm.main(argv) == 2
    want = capsys.readouterr().err
    assert lm.main(argv + ["--device", "cpu", "--fake-devices", "8"]) == 2
    got = capsys.readouterr()
    assert got.err == want and got.out == ""


def test_save_params_writes_whole_leaves(capsys, tmp_path):
    """``--fsdp --save-params`` gathers the pieces: the archive holds the
    JAX tree's leaves whole, and the JAX package's loader reads it."""
    path = tmp_path / "fsdp.npz"
    assert lm.main(BASE + ["--fsdp", "--fake-devices", "4", "--batch", "4", "--steps", "1", "--target-loss", "1e9",
                           "--generate", "0", "--save-params", str(path)]) == 0
    assert f"Saved params to {path}" in capsys.readouterr().out
    like = jinit(jax.random.PRNGKey(0), JTINY)
    loaded = jckpt.load_params_npz(str(path), like=like)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(like)):
        assert np.asarray(a).shape == b.shape
