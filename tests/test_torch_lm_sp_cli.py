"""The ``examples/lm.py`` CLI with sequence-parallel attention on the CPU:
``--attn ring|ulysses --shards 2`` with each ``--sp-engine``, two CPU slots,
``--fake-devices`` accepted. Each run must converge (the loss under the
CLI's 1.0 target) and continue the pattern, as the JAX CLI's runs do. Its
guards, in the JAX CLI's words, are in ``tests/test_torch_train_cli.py``;
the sequence-parallel step against the JAX package's in
``tests/test_torch_lm_tp.py``. A file of its own, so these runs do not
lengthen the CLI file's worker.
"""

import pytest

from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import lm
from torch_threads import one_intra_op_thread  # noqa: unused-import (an autouse fixture)


@pytest.mark.parametrize("sp_engine", ["einsum", "flash"])
@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_cli_trains_with_sequence_parallel_attention(capsys, attn, sp_engine):
    rc = lm.main(["--device", "cpu", "--steps", "20", "--seq-len", "32", "--batch", "2", "--attn", attn,
                  "--shards", "2", "--sp-engine", sp_engine, "--fake-devices", "2", "--generate", "8"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f"--- Byte-LM training [{attn}] (shards=2, L=32, batch=2, layers=2, d=128" in out
    assert "Mesh: 2 shards on 1 device: cpu" in out
    assert "-> PASSED" in out.split("Verification: loss ")[1].splitlines()[0]
    assert "Generation continuation: PASSED" in out
