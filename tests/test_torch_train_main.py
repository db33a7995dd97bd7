"""The port's training CLI (``train.py``) against the JAX package's, on the CPU.

The same student (a JAX-drawn random init saved to npz, ``--resume``), the
same deterministic teacher and the same native batch stream through both
CLIs at 63x63: the first step's loss agrees within rtol 1e-5 and a 6-step
sgd trajectory within rtol 1e-4, on one device and at ``--sp 4`` (the
gradients come from ``torch.autograd`` against ``jax.value_and_grad``, so
the sums round differently). Then the JAX ``tests/test_train_cli.py`` cases
on the port with the JAX tests' own assertions (resume, the sdc drill's
trajectory equal to the clean run's, the nan drills, the rc 3 cases,
``--no-sentinel``), the sharded checkpoint, the supervised drill's
``Elastic:`` and ``Health:`` lines, the exit-2 guards, and the single-npz
train state cross-loading bit-exact between the packages. The JAX side
runs once per module.
"""

import contextlib
import dataclasses
import io
import re

import jax
import numpy as np
import optax
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu import train as jtrain
from cuda_mpi_gpu_cluster_programming_tpu.models import alexnet as jalex
from cuda_mpi_gpu_cluster_programming_tpu.models import init as jinit
from cuda_mpi_gpu_cluster_programming_tpu.resilience import chaos as jchaos
from cuda_mpi_gpu_cluster_programming_tpu.utils import checkpoint as jckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch import train
from cuda_mpi_gpu_cluster_programming_tpu_torch.observability.health import health_from_journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import checkpoint as tckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_paths

_SMALL = ["--batch", "2", "--height", "63", "--width", "63"]
CPU = ["--device", "cpu"]


def _chaos(monkeypatch, spec):
    for mod in (chaos, jchaos):
        if spec is None:
            monkeypatch.delenv(mod.CHAOS_ENV, raising=False)
        else:
            monkeypatch.setenv(mod.CHAOS_ENV, spec)
        mod.reset()


@pytest.fixture(autouse=True)
def _chaos_off(monkeypatch):
    _chaos(monkeypatch, None)
    yield
    chaos.reset()
    jchaos.reset()


def _main(fn, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(args)
    return rc, out.getvalue(), err.getvalue()


def run(args, capsys):
    rc = train.main(args + CPU)
    return rc, capsys.readouterr().out


def _losses(out):
    return [float(line.split("loss = ")[1]) for line in out.splitlines() if "loss = " in line]


# ------------------------------------------------ against the JAX CLI ---


@pytest.fixture(scope="module")
def student(tmp_path_factory):
    """A JAX-drawn random student (seed 0), the npz both CLIs resume from."""
    path = tmp_path_factory.mktemp("train_main") / "student.npz"
    cfg = dataclasses.replace(jalex.BLOCKS12, in_height=63, in_width=63)
    jckpt.save_params_npz(path, jinit.init_params_random(jax.random.PRNGKey(0), cfg))
    return str(path)


@pytest.fixture(scope="module")
def jax_losses(student):
    """The JAX CLI's 6-step sgd losses, single device and ``--sp 4``."""
    out = {}
    for name, extra in (("single", []), ("sp4", ["--sp", "4"])):
        rc, text, err = _main(jtrain.main, ["--steps", "6", "--resume", student] + _SMALL + extra)
        assert rc == 0, err
        out[name] = _losses(text)
    return out


@pytest.mark.parametrize("name,extra", [("single", []), ("sp4", ["--sp", "4"])])
def test_trajectory_matches_the_jax_cli(student, jax_losses, name, extra):
    rc, text, err = _main(train.main, ["--steps", "6", "--resume", student] + _SMALL + extra + CPU)
    assert rc == 0, err
    got, want = _losses(text), jax_losses[name]
    assert len(got) == len(want) == 6
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert f"Resumed student from {student}" in text


def test_sp_and_single_first_steps_agree(student, capsys):
    _, single = run(["--steps", "1", "--resume", student] + _SMALL, capsys)
    _, sp = run(["--steps", "1", "--resume", student, "--sp", "4"] + _SMALL, capsys)
    assert _losses(single)[0] == pytest.approx(_losses(sp)[0], rel=1e-5)
    assert "Mesh: 4 shards on 1 device: cpu" in sp


def test_printed_lines_are_the_jax_clis(student):
    args = ["--steps", "2", "--resume", student, "--sp", "2"] + _SMALL
    _, jout, _ = _main(jtrain.main, args)
    _, tout, _ = _main(train.main, args + CPU)

    def shape(text):
        return [re.sub(r"[0-9.]+", "N", line) for line in text.splitlines()
                if not line.startswith(("Devices:", "Mesh:"))]

    assert shape(tout) == shape(jout)
    assert tout.splitlines()[1] == ("--- Training (teacher-student, sgd, lr=0.001, batch=2, dp=1, sp=2, remat=False, "
                                    "H=63) ---")


# ------------------------------------- the JAX tests/test_train_cli.py cases ---


def test_loss_decreases_single_device(capsys):
    rc, out = run(["--steps", "12", "--batch", "2", "--optimizer", "adam", "--lr", "0.05"], capsys)
    assert rc == 0
    losses = _losses(out)
    assert len(losses) == 12
    assert losses[-1] < losses[0] * 0.8, losses


def test_dp_sp_mesh_with_remat(capsys):
    rc, out = run(["--steps", "3", "--batch", "2", "--sp", "4", "--dp", "2", "--remat"], capsys)
    assert rc == 0
    assert "dp=2, sp=4, remat=True" in out
    assert "Training completed in" in out
    assert "Mesh: 4 shards x 2 data-parallel replicas on 1 device: cpu" in out


def test_sp_matches_single_device_first_step(capsys):
    _, out_single = run(["--steps", "1", "--batch", "2", "--seed", "7"], capsys)
    _, out_sp = run(["--steps", "1", "--batch", "2", "--seed", "7", "--sp", "8"], capsys)
    np.testing.assert_allclose(_losses(out_single)[0], _losses(out_sp)[0], rtol=1e-5)


def test_checkpoint_resume_roundtrip(tmp_path, capsys):
    ckpt = str(tmp_path / "w.npz")
    rc, out = run(["--steps", "2", "--batch", "1", "--checkpoint", ckpt], capsys)
    assert rc == 0 and f"Saved params to {ckpt}" in out
    params = tckpt.load_params_npz(ckpt)
    assert set(params) == {"conv1", "conv2"}
    assert set(jckpt.load_params_npz(ckpt)) == {"conv1", "conv2"}  # the JAX package reads it too
    rc2, out2 = run(["--steps", "1", "--batch", "1", "--resume", ckpt], capsys)
    assert rc2 == 0 and "Resumed student from" in out2


def test_many_slots_share_the_device_instead_of_a_device_guard(capsys):
    """The JAX CLI's ``need 64 devices`` has no counterpart: 64 data-parallel
    slots share the one device, and the Mesh line says so."""
    rc, out = run(["--steps", "1", "--dp", "64", "--fake-devices", "8"], capsys)
    assert rc == 0
    assert "Mesh: 1 shard x 64 data-parallel replicas on 1 device: cpu" in out


def test_checkpoint_every_matches_loader_stream(tmp_path, capsys):
    rc1, out_plain = run(["--steps", "3"] + _SMALL, capsys)
    rc2, out_ck = run(["--steps", "3", "--checkpoint-every", "2", "--work-dir", str(tmp_path / "w")] + _SMALL, capsys)
    assert rc1 == 0 and rc2 == 0
    assert len(_losses(out_plain)) == 3
    assert _losses(out_plain) == _losses(out_ck)


def test_checkpoint_every_resume_continues_where_killed(tmp_path, capsys):
    work = str(tmp_path / "w")
    rc, out1 = run(["--steps", "4", "--checkpoint-every", "2", "--work-dir", work] + _SMALL, capsys)
    assert rc == 0
    rc, out2 = run(["--steps", "8", "--checkpoint-every", "2", "--work-dir", work] + _SMALL, capsys)
    assert rc == 0
    assert "Resumed training state" in out2 and "at step 4" in out2
    assert "Step 5/8" in out2 and "Step 1/8" not in out2
    rc, out_full = run(["--steps", "8", "--checkpoint-every", "2", "--work-dir", str(tmp_path / "w2")] + _SMALL,
                       capsys)
    assert _losses(out1) + _losses(out2) == _losses(out_full)
    rc, out3 = run(["--steps", "8", "--checkpoint-every", "2", "--work-dir", work] + _SMALL, capsys)
    assert rc == 0 and "already complete at step 8" in out3


def test_sdc_bitflip_detected_rolled_back_trajectory_matches_clean(tmp_path, capsys, monkeypatch):
    args = ["--steps", "6", "--checkpoint-every", "2"] + _SMALL
    rc, clean = run(args + ["--work-dir", str(tmp_path / "clean")], capsys)
    assert rc == 0
    _chaos(monkeypatch, "seed=3,sdc=1")
    rc, drilled = run(args + ["--work-dir", str(tmp_path / "sdc")], capsys)
    assert rc == 0
    assert "chaos: injected sdc bit-flip" in drilled
    assert "SDC(" in drilled and "rollback to last-good step" in drilled
    assert "Sentinel fault log: retried" in drilled
    assert _losses(drilled) == _losses(clean)
    kinds = [r["kind"] for r in Journal.load(tmp_path / "sdc" / "journal.jsonl")]
    assert "rollback" in kinds and kinds.count("step") == 6


def test_nan_loss_drill_rolls_back_and_recovers(tmp_path, capsys, monkeypatch):
    _chaos(monkeypatch, "nan_loss=1")
    rc, out = run(["--steps", "4", "--checkpoint-every", "2", "--work-dir", str(tmp_path / "w")] + _SMALL, capsys)
    assert rc == 0
    assert "chaos: injected nan_loss" in out
    assert "SDC(nan_loss)" in out and "rollback" in out
    assert len(_losses(out)) == 4


def test_nan_loss_without_checkpoint_aborts_rc3(capsys, monkeypatch):
    _chaos(monkeypatch, "nan_loss=1")
    rc = train.main(["--steps", "3"] + _SMALL + CPU)
    err = capsys.readouterr().err
    assert rc == 3
    assert "SDC(nan_loss)" in err and "no checkpoint" in err


def test_rollback_budget_exhaustion_aborts_rc3(tmp_path, capsys, monkeypatch):
    _chaos(monkeypatch, "nan_loss=99")
    rc = train.main(["--steps", "4", "--checkpoint-every", "2", "--max-rollbacks", "2",
                     "--work-dir", str(tmp_path / "w")] + _SMALL + CPU)
    err = capsys.readouterr().err
    assert rc == 3
    assert "2 consecutive rollbacks exhausted" in err


def test_no_sentinel_flag_disables_screening(capsys, monkeypatch):
    _chaos(monkeypatch, "nan_loss=1")
    rc, out = run(["--steps", "2", "--no-sentinel"] + _SMALL, capsys)
    assert rc == 0
    assert "nan" in out


# ------------------------------------------------- the port's own cases ---


def test_sharded_checkpoint_resumes(tmp_path, capsys):
    work = str(tmp_path / "w")
    args = ["--checkpoint-every", "2", "--checkpoint-shards", "4", "--work-dir", work] + _SMALL
    rc, out1 = run(["--steps", "2"] + args, capsys)
    assert rc == 0 and (tmp_path / "w" / "ckpt_last_good" / "MANIFEST.json").exists()
    assert len(list((tmp_path / "w" / "ckpt_last_good").glob("shard_*.npz"))) == 4
    rc, out2 = run(["--steps", "4"] + args, capsys)
    assert rc == 0 and "Resumed training state" in out2 and "at step 2" in out2
    rc, full = run(["--steps", "4", "--checkpoint-every", "2", "--work-dir", str(tmp_path / "f")] + _SMALL, capsys)
    assert _losses(out1) + _losses(out2) == _losses(full)


def test_supervised_device_loss_replays_and_folds(tmp_path, capsys, monkeypatch):
    """``--sp 4 --supervise-steps`` under a device-loss drill: the step
    replays on a smaller rung, no rollback, and the work-dir journal folds
    into one trip incident whose phases sum to its wall."""
    _chaos(monkeypatch, "seed=3,device_loss=1")
    rc, out = run(["--steps", "3", "--sp", "4", "--checkpoint-every", "2", "--supervise-steps",
                   "--work-dir", str(tmp_path / "w")] + _SMALL, capsys)
    assert rc == 0, out
    elastic = next(line for line in out.splitlines() if line.startswith("Elastic: "))
    assert int(re.search(r"replays=(\d+)", elastic).group(1)) >= 1 and "kinds=device_loss" in elastic
    health = next(line for line in out.splitlines() if line.startswith("Health: "))
    assert "unavailable" not in health and "incidents=1 " in health
    assert "rollback" not in out and len(_losses(out)) == 3
    rep = health_from_journal(tmp_path / "w" / "journal.jsonl")
    (trip,) = rep.trips
    assert trip.cause == "device_loss" and trip.t0_ms is not None and trip.phases["compile"] is not None
    assert trip.phase_sum_ms == pytest.approx(trip.wall_ms, abs=1e-6)


@pytest.mark.parametrize("args,words", [
    (["--steps", "0"], "--steps must be >= 1"),
    (["--height", "5", "--width", "5"], "degenerate model"),
    (["--sp", "2", "--tp", "2"], "mutually exclusive"),
    (["--tp", "2", "--dp", "2"], "--tp does not compose with --dp"),
    (["--supervise-steps"], "--supervise-steps requires --checkpoint-every"),
])
def test_usage_guards_exit_2(args, words, capsys):
    assert train.main(args + CPU) == 2
    assert words in capsys.readouterr().err


def test_cuda_without_a_gpu_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    assert train.main(["--steps", "1"]) == 2
    assert "no CUDA device is available" in capsys.readouterr().err


# ------------------------------------------ the single-npz train state ---


def _bits(tree):
    return [(p, np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)) for p, v in tree_paths(tree)]


def test_train_state_cross_loads_bit_exact(tmp_path):
    rng = np.random.default_rng(5)
    params = {"conv1": {"w": rng.standard_normal((11, 11, 3, 4)).astype(np.float32),
                        "b": np.array([np.nan, -0.0, np.inf, 1e-40], np.float32)},
              "conv2": {"w": rng.standard_normal((5, 5, 4, 8)).astype(np.float32),
                        "b": rng.standard_normal(8).astype(np.float32)}}
    opt = optax.sgd(1e-3)
    jckpt.save_train_state(tmp_path / "j.npz", params, opt.init(params), 12)
    like = {k: {n: torch.zeros(v.shape) for n, v in d.items()} for k, d in params.items()}
    p, o, step = tckpt.load_train_state(tmp_path / "j.npz", like, ())
    assert step == 12 and o == ()
    assert all(a[0] == b[0] and a[1].tobytes() == b[1].tobytes() for a, b in zip(_bits(p), _bits(params)))
    tckpt.save_train_state(tmp_path / "t.npz", p, o, 13)
    jp, jo, jstep = jckpt.load_train_state(tmp_path / "t.npz", params, opt.init(params))
    assert jstep == 13
    assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params)))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)


def test_a_truncated_train_state_raises_value_error(tmp_path):
    tckpt.save_train_state(tmp_path / "s.npz", {"w": torch.ones(3)}, (), 1)
    data = (tmp_path / "s.npz").read_bytes()
    (tmp_path / "s.npz").write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="truncated or corrupt"):
        tckpt.load_train_state(tmp_path / "s.npz", {"w": torch.ones(3)}, ())
