"""The port's ``run.py`` flags for full AlexNet and its single-device
options (``--params``, ``--save-params``, ``--input native``, ``--trace``,
``--max-retries``, ``--fallback-chain``), on the CPU at 99x99, against the
JAX package's ``run.py`` where both packages run: a checkpoint either saves
runs in the other, and the native input is one stream. Printed first-10s
agree to atol 2e-3 (the V6 golden's tolerance, ``tests/oracle.py``). Then
the serving control plane's flags at 63x63: ``--serve-controller`` and its
``Serve controller:`` line, ``--serve-replay`` with its knobs and exit
codes, ``--replay-devices`` above 1, and what the fleet flags still
refuse."""

import re

import numpy as np
import pytest

from cuda_mpi_gpu_cluster_programming_tpu import configs as jcfg
from cuda_mpi_gpu_cluster_programming_tpu import run as jrun
from cuda_mpi_gpu_cluster_programming_tpu.resilience import policy as jpolicy
from cuda_mpi_gpu_cluster_programming_tpu_torch import run as trun
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import chaos
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience import policy as tpolicy
from cuda_mpi_gpu_cluster_programming_tpu_torch.resilience.journal import Journal
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.checkpoint import load_params_npz

SMALL = ["--device", "cpu", "--height", "99", "--width", "99", "--batch", "1", "--repeats", "1", "--warmup", "1"]
CONTRACT = ("Precision: dtype=fp32", "Compile time:", "Final Output Shape: 1000", "Final Output (first 10 values):",
            "Forward Pass completed in", "Timing stats:", "Kernel launches:")


@pytest.fixture(autouse=True)
def _no_chaos(monkeypatch):
    for var in ("CHAOS_SPEC", "TPU_FRAMEWORK_FUSE", "TPU_FRAMEWORK_CONV", "TPU_FRAMEWORK_POOL",
                "TPU_FRAMEWORK_KBLOCK", "TPU_FRAMEWORK_ROWBLOCK"):
        monkeypatch.delenv(var, raising=False)
    chaos.reset()
    yield
    chaos.reset()


def _first10(out):
    return np.array([float(v) for v in re.search(r"^Final Output \(first 10 values\): (.+)$", out, re.M)
                     .group(1).split()])


def _port(capsys, *argv):
    rc = trun.main(list(argv))
    out, err = capsys.readouterr()
    return rc, out, err


def test_v6_tiers_print_the_same_logits(capsys):
    outs = {}
    for key in ("v6_full_pallas", "v6_full_jit"):
        for init in ("deterministic", "random"):
            rc, out, _err = _port(capsys, "--config", key, "--init", init, *SMALL)
            assert rc == 0 and all(line in out for line in CONTRACT), out
            outs[key, init] = _first10(out)
    for init in ("deterministic", "random"):
        np.testing.assert_allclose(outs["v6_full_pallas", init], outs["v6_full_jit", init], rtol=2e-5, atol=2e-4)
    assert len(set(outs["v6_full_jit", "random"][:5])) == 5
    assert _port(capsys, "--list-configs")[1].count("v6_full_") == 3  # jit, pallas and sharded


def test_save_params_then_params_prints_the_same_first10(tmp_path, capsys):
    path = tmp_path / "w.npz"
    rc, saved, _ = _port(capsys, "--config", "v6_full_pallas", "--init", "random", "--seed", "3",
                         "--save-params", str(path), *SMALL)
    assert rc == 0 and f"Saved params to {path}" in saved
    tree = load_params_npz(path)
    assert sorted(tree) == ["conv1", "conv2", "conv3", "conv4", "conv5", "fc6", "fc7", "fc8"]
    assert tuple(tree["fc6"]["w"].shape) == (2 * 2 * 256, 4096)
    rc, loaded, _ = _port(capsys, "--config", "v6_full_pallas", "--init", "random", "--seed", "3",
                          "--params", str(path), *SMALL)
    assert rc == 0 and f"Loaded params from {path}" in loaded
    np.testing.assert_array_equal(_first10(loaded), _first10(saved))


@pytest.mark.parametrize("key", ["v6_full_jit", "v1_jit"])
def test_a_jax_checkpoint_and_native_input_run_in_the_port(key, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TPU_FRAMEWORK_COMPILE_CACHE", "0")  # no XLA cache written by this test
    path = tmp_path / "p.npz"
    common = ["--config", key, "--init", "random", "--seed", "0", "--input", "native", "--height", "99",
              "--width", "99", "--batch", "1", "--repeats", "1", "--warmup", "1"]
    assert jrun.main(common + ["--save-params", str(path)]) == 0
    jax_out = capsys.readouterr().out
    rc, out, _ = _port(capsys, *common, "--params", str(path), "--device", "cpu")
    assert rc == 0 and f"Loaded params from {path}" in out
    np.testing.assert_allclose(_first10(out), _first10(jax_out), atol=2e-3)


def test_trace_journals_the_measure_span(tmp_path, capsys):
    path = tmp_path / "trace.jsonl"
    rc, out, _ = _port(capsys, "--config", "v6_full_jit", "--trace", str(path), *SMALL)
    trace_id = re.search(r"^Trace: id=(\w+) journal=(\S+)$", out, re.M)
    assert rc == 0 and trace_id and trace_id.group(2) == str(path)
    spans = [r for r in Journal.load(path) if r["kind"] == "span"]
    (measure,) = [r for r in spans if r["name"] == "run.measure"]
    assert measure["trace_id"] == trace_id.group(1) and measure["attrs"]["config"] == "v6_full_jit"
    assert measure["attrs"]["per_pass_ms"] > 0


@pytest.mark.parametrize("key,fallback", [("v3_pallas", "v1_jit"), ("v6_full_pallas", "v6_full_jit")])
def test_a_kernel_build_fault_degrades_only_with_the_flag(key, fallback, monkeypatch, capsys):
    monkeypatch.setenv("CHAOS_SPEC", "kernel_compile=1")
    rc, out, _ = _port(capsys, "--config", key, "--fallback-chain", "auto", *SMALL)
    assert rc == 0 and f"DEGRADED({key} -> {fallback}): InjectedFault: chaos: injected kernel_compile" in out
    shape = "5x5x256" if key == "v3_pallas" else "1000"
    assert all(line in out for line in CONTRACT[:2] + CONTRACT[3:]) and f"Final Output Shape: {shape}" in out
    chaos.reset()
    rc, out, err = _port(capsys, "--config", key, "--max-retries", "1", *SMALL)
    assert rc == 0 and "DEGRADED" not in out and f"Final Output Shape: {shape}" in out
    chaos.reset()
    rc, out, err = _port(capsys, "--config", key, *SMALL)
    assert rc == 2 and "DEGRADED" not in out and f"cannot build config {key!r}" in err


@pytest.mark.parametrize("argv,why", [
    (["--config", "v6_full_pallas", "--fallback-chain", "v1_jit"], "crosses model families"),
    (["--config", "v3_pallas", "--fallback-chain", "v2.3_missing"], "unknown configs"),
    (["--config", "v7_tp", "--shards", "3"], "not divisible by 3 TP shards"),
    (["--config", "v6_full_jit", "--supervise"], "Blocks 1-2"),
    (["--config", "v2.2_sharded", "--supervise", "--fallback-chain", "auto"], "degradation ladder"),
])
def test_refused_flags_exit_2(argv, why, capsys):
    rc, _out, err = _port(capsys, *argv, "--device", "cpu")
    assert rc == 2 and why in err


def test_tier_fallback_chain_is_the_jax_packages():
    for key in jcfg.REGISTRY:
        assert tpolicy.tier_fallback_chain(key) == jpolicy.tier_fallback_chain(key)
    events = []
    d = tpolicy.Degrader(["a", "b", "c"], on_event=events.append)
    assert d.run(lambda t: t if t == "c" else (_ for _ in ()).throw(RuntimeError(f"{t} down"))) == ("c", "c")
    assert [str(e) for e in events] == ["DEGRADED(a -> b): RuntimeError: a down",
                                        "DEGRADED(b -> c): RuntimeError: b down"]
    with pytest.raises(tpolicy.DegradationExhausted, match="all 2 tiers failed"):
        tpolicy.Degrader(["a", "b"]).run(lambda t: (_ for _ in ()).throw(RuntimeError(t)))
    with pytest.raises(KeyError):
        tpolicy.Degrader(["a", "b"], should_degrade=lambda e: False).run(lambda t: {}[t])


def test_breakdown_walks_the_full_chain(capsys):
    for key in ("v6_full_jit", "v6_full_pallas"):
        rc, out, _ = _port(capsys, "--config", key, "--breakdown", *SMALL)
        layers = re.findall(r"^Layer (\S+) completed in [0-9.]+ ms -> (\S+)$", out, re.M)
        assert rc == 0 and [n for n, _s in layers] == ["conv1", "pool1", "conv2", "pool2", "lrn2", "conv3", "conv4",
                                                       "conv5", "pool5", "fc6", "fc7", "fc8"]
        assert layers[8][1] == "2x2x256" and layers[-1][1] == "1000"


# ----------------------------------------------- the serving control plane ---

SERVE = ["--config", "v1_jit", "--serve", "--device", "cpu", "--height", "63", "--width", "63",
         "--serve-max-batch", "2", "--serve-rate", "10", "--serve-duration", "0.3"]


def test_serve_controller_prints_its_line(tmp_path, capsys):
    journal = tmp_path / "serve.jsonl"
    rc, out, _ = _port(capsys, *SERVE, "--serve-controller", "--traffic-shape", "steady",
                       "--serve-journal", str(journal))
    assert rc == 0, out
    assert re.search(r"^Serve controller: mode=(steady|degraded) level=\d+ actions=\S+$", out, re.M), out
    assert "inert" not in out
    (config,) = [r for r in Journal.load(journal) if r["kind"] == "serve_config"]
    assert config["controller"]["protected_cls"] == "interactive" and config["slo"] is not None
    rc, out, _ = _port(capsys, *SERVE, "--serve-controller")
    assert rc == 0 and "Serve controller: inert" in out and "Serve controller: mode=steady level=0 actions=none" in out


def test_serve_replay_re_drives_a_recorded_journal(tmp_path, capsys):
    journal = tmp_path / "serve.jsonl"
    assert _port(capsys, *SERVE, "--traffic-shape", "steady", "--serve-journal", str(journal))[0] == 0
    rc, out, err = _port(capsys, "--serve-replay", str(journal), "--device", "cpu",
                         "--replay-journal", str(tmp_path / "replay.jsonl"))
    assert f"Replay source: {journal}" in out and "Replay journal: " in out
    line = re.search(r"^Replay: (.+)$", out, re.M).group(1)
    assert "accounting_matches=True closed=True" in line and "devices=recorded" in line
    assert rc == (3 if "diverged=True" in line else 0), out + err  # a neutral divergence exits 3, as in JAX
    assert re.search(r"^Replay class: name=interactive offered=(\d+)/\1 ", out, re.M)
    rc, out, _ = _port(capsys, "--serve-replay", str(journal), "--device", "cpu", "--replay-mult", "2",
                       "--replay-slo-scale", "0.5", "--replay-journal", str(tmp_path / "x2.jsonl"))
    assert rc == 0 and "mult=2 " in out and "diverged=False" in out
    rc, out, _ = _port(capsys, "--serve-replay", str(journal), "--device", "cpu", "--replay-devices", "2",
                       "--replay-journal", str(tmp_path / "d2.jsonl"))
    assert rc == 0 and "devices=2 " in out and "accounting_matches=True" in out


@pytest.mark.parametrize("argv,why", [
    (["--serve-replay", "missing.jsonl"], "no serve_submit records"),
    (["--serve-replay", "x.jsonl", "--replay-mult", "0"], "must be > 0"),
    (["--serve", "--route", "-1"], "--route must be >= 0"),
    (["--serve", "--route", "2", "--supervise"], "unsupervised backends"),
])
def test_what_the_control_plane_refuses_exits_2(argv, why, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, _, err = _port(capsys, "--device", "cpu", *argv)
    assert rc == 2 and why in err


def test_supervise_refusals_are_the_jax_clis(capsys):
    """``--supervise`` refuses full AlexNet and ``--fallback-chain`` with the
    JAX CLI's exit code and words."""
    for argv in (["--config", "v6_full_jit", "--supervise"],
                 ["--config", "v2.2_sharded", "--supervise", "--fallback-chain", "auto"]):
        assert jrun.main(argv) == 2
        jerr = capsys.readouterr().err.strip().splitlines()[-1]
        rc, _out, err = _port(capsys, *argv, "--device", "cpu")
        assert rc == 2 and err.strip().splitlines()[-1] == jerr
