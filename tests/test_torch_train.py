"""The port's LM training path against the JAX package's: ``lm_loss``
gradients, ``make_lm_train_step`` (accumulation, bf16 mixed precision,
remat), the Adam of ``utils/optim.py``, the npz checkpoints and the
``examples/lm.py`` CLI.

Both packages run on the CPU with the same weights (the JAX package's
``init_transformer`` tree, carried over by ``lm_params_from_jax``) and the
same tokens, made with numpy from a seed. The port's flash attention runs
the plain versions of its forward and backward kernels on the CPU, the JAX
package its Pallas kernels in interpret mode.

Tolerances and why:
- gradients: each leaf within 1e-5 x its max |JAX grad|: the same fp32
  function, summed in other orders (the measured gap is under 1e-6 of it);
- losses: rtol 1e-5 (``tests/test_torch_transformer.py``'s ``lm_loss``);
- params after 1 and 3 Adam steps (lr 1e-2): 1e-4 abs, 1% of one step.
  Adam's early steps are about lr x sign(g), so fp32 rounding of a
  gradient moves a param far less than that;
- accumulation against the full batch, remat against none: the JAX tests'
  own (loss rtol 1e-6; params or gradients rtol 1e-5, atol 1e-6);
- ``utils.optim.adam`` against ``optax.adam``: rtol 1e-6, atol 1e-7 (the
  same operations in the same order; they agree bit for bit here);
- npz checkpoints: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import transformer as jtf
from cuda_mpi_gpu_cluster_programming_tpu.utils import checkpoint as jckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import lm
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as ttf
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import checkpoint as tckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import optim
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# tests/test_decode.py's config, dense, and a top-1 MoE whose capacity drops tokens
GRAD_KW = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=96)
MOE_KW = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=64, n_experts=4, capacity_factor=0.5)
# tests/test_transformer.py's training configs
STEP_KW = dict(d_model=32, n_heads=2, n_layers=2, d_ff=64, max_len=32)
MIXED_KW = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=64)


def _pair(kw, seed=0, **over):
    """(JAX config, port config, JAX params, port params) for the same weights."""
    jcfg = jtf.TransformerConfig(**kw, **over)
    tcfg = ttf.TransformerConfig(**kw, **over)
    jparams = jtf.init_transformer(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, ttf.lm_params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _grad_close(got, want, rel=1e-5):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= rel * float(np.abs(w).max()), float(np.abs(g - w).max())


def _torch_grad(loss_fn, params):
    leaves = [t.detach().clone().requires_grad_(True) for t in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves))
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("which", ["dense", "moe"])
def test_lm_loss_gradients_match_jax(which, impl):
    kw = GRAD_KW if which == "dense" else MOE_KW
    jcfg, tcfg, jparams, params = _pair(kw, seed=3, attn_impl=impl)
    toks = _tokens((2, 41), 3)
    want_loss, want = jax.value_and_grad(lambda p: jtf.lm_loss(p, jnp.asarray(toks), jcfg))(jparams)
    loss, got = _torch_grad(lambda p: ttf.lm_loss(p, torch.from_numpy(toks), tcfg), params)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert len(got) == len(jax.tree.leaves(want))
    _grad_close(got, jax.tree.leaves(want))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_train_steps_match_jax_optax_adam(impl, steps):
    """``make_lm_train_step``'s default optimizer is the port's Adam; the
    JAX step's is ``optax.adam``: losses and params step by step."""
    jcfg, tcfg, jparams, params = _pair(STEP_KW, attn_impl=impl)
    toks = _tokens((4, 17), 1)
    j_init, j_step = jtf.make_lm_train_step(jcfg, lr=1e-2)
    t_init, t_step = ttf.make_lm_train_step(tcfg, lr=1e-2)
    j_state, t_state = j_init(jparams), t_init(params)
    for _ in range(steps):
        jparams, j_state, j_loss = j_step(jparams, j_state, jnp.asarray(toks))
        params, t_state, t_loss = t_step(params, t_state, torch.from_numpy(toks))
        assert t_loss.dtype == torch.float32 and t_loss.dim() == 0
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert int(t_state["count"]) == steps
    for got, want in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        assert got.dtype == torch.float32 and not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_train_step_leaves_its_inputs_as_they_were():
    _, tcfg, _, params = _pair(STEP_KW, attn_impl="flash")
    before = tree_map(torch.clone, params)
    init, step = ttf.make_lm_train_step(tcfg)
    state = init(params)
    new, _, _ = step(params, state, torch.from_numpy(_tokens((2, 9), 2)))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(before)))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(before)))
    assert int(state["count"]) == 0


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_grad_accumulation_matches_full_batch(impl):
    """accum_steps=4 (four microbatches, one update) against the full-batch
    step, as tests/test_transformer.py holds the JAX package's."""
    _, tcfg, _, params = _pair(STEP_KW, attn_impl=impl)
    toks = torch.from_numpy(_tokens((8, 17), 0))
    oi1, s1 = ttf.make_lm_train_step(tcfg, lr=1e-2)
    oi4, s4 = ttf.make_lm_train_step(tcfg, lr=1e-2, accum_steps=4)
    p1, _, l1 = s1(params, oi1(params), toks)
    p4, _, l4 = s4(params, oi4(params), toks)
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-6)
    for a, b in zip(tree_leaves(p4), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_accum_steps_errors_in_the_jax_words():
    jcfg, tcfg, jparams, params = _pair(STEP_KW)
    toks = _tokens((8, 17), 0)
    with pytest.raises(ValueError) as want:
        jtf.make_lm_train_step(jcfg, accum_steps=3)[1](jparams, optax.adam(1e-3).init(jparams), jnp.asarray(toks))
    init, step = ttf.make_lm_train_step(tcfg, accum_steps=3)
    with pytest.raises(ValueError) as got:
        step(params, init(params), torch.from_numpy(toks))
    assert str(got.value) == str(want.value) == "batch 8 not divisible by accum_steps 3"
    with pytest.raises(ValueError) as want:
        jtf.make_lm_train_step(jcfg, accum_steps=0)
    with pytest.raises(ValueError) as got:
        ttf.make_lm_train_step(tcfg, accum_steps=0)
    assert str(got.value) == str(want.value) == "accum_steps must be >= 1, got 0"


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_mixed_precision_master_weights(impl):
    """compute_dtype=bf16: forward and backward in bf16 (the flash kernels'
    plain versions on bf16 operands), params and optimizer state fp32;
    the loss halves in 30 steps on the pattern task, as in
    tests/test_transformer.py."""
    _, tcfg, _, params = _pair(MIXED_KW, attn_impl=impl)
    pattern = torch.arange(8).repeat(9)[None, :65].repeat(4, 1)
    init, step = ttf.make_lm_train_step(tcfg, lr=3e-3, compute_dtype=torch.bfloat16)
    state = init(params)
    first = None
    for _ in range(30):
        params, state, loss = step(params, state, pattern)
        first = float(loss) if first is None else first
    assert float(loss) < first * 0.5
    for leaf in tree_leaves(params) + tree_leaves(state["mu"]) + tree_leaves(state["nu"]):
        assert leaf.dtype == torch.float32  # masters never degrade to bf16


def test_mixed_precision_differentiates_at_bf16(monkeypatch):
    """The loss sees bf16 params (cast once a step) and the update fp32 grads."""
    _, tcfg, _, params = _pair(STEP_KW, attn_impl="flash")
    seen = []

    def loss_fn(p, t):
        seen.append({leaf.dtype for leaf in tree_leaves(p)})
        return ttf.lm_loss(p, t, tcfg)

    grads_seen = []
    init, update = optim.adam(1e-3)

    def spy(grads, state, p=None):
        grads_seen.append({g.dtype for g in tree_leaves(grads)})
        return update(grads, state, p)

    _, step = ttf.make_lm_train_step(tcfg, optimizer=(init, spy), loss_fn=loss_fn, accum_steps=2,
                                     compute_dtype=torch.bfloat16)
    step(params, init(params), torch.from_numpy(_tokens((4, 9), 5)))
    assert seen == [{torch.bfloat16}, {torch.bfloat16}] and grads_seen == [{torch.float32}]


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_remat_same_loss_and_grads_and_it_recomputes(monkeypatch, impl):
    """cfg.remat runs each block under torch.utils.checkpoint: loss and
    gradients unchanged, and the backward runs every block's forward again."""
    kw = dict(d_model=32, n_heads=2, n_layers=3, d_ff=64, max_len=32)
    _, base, _, params = _pair(kw, attn_impl=impl)
    rcfg = dataclasses.replace(base, remat=True)
    toks = torch.from_numpy(_tokens((2, 17), 0))
    calls = []
    block = ttf.decoder_block
    monkeypatch.setattr(ttf, "decoder_block", lambda *a, **k: calls.append(1) or block(*a, **k))
    l_base, g_base = _torch_grad(lambda p: ttf.lm_loss(p, toks, base), params)
    assert len(calls) == 3
    del calls[:]
    l_remat, g_remat = _torch_grad(lambda p: ttf.lm_loss(p, toks, rcfg), params)
    assert len(calls) == 6  # 3 forwards, then 3 recomputed in the backward
    np.testing.assert_allclose(float(l_remat), float(l_base), rtol=1e-6)
    for a, b in zip(g_remat, g_base):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    with torch.inference_mode():  # no gradient, nothing to recompute
        np.testing.assert_allclose(float(ttf.lm_loss(params, toks, rcfg)), float(l_base), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(b1=0.8, b2=0.99, eps=1e-6, eps_root=1e-8)])
def test_adam_matches_optax_adam(kw):
    rng = np.random.default_rng(4)
    arrs = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "layers": [{"g": rng.standard_normal((4,)).astype(np.float32)} for _ in range(2)]}
    jp = jax.tree.map(jnp.asarray, arrs)
    tp = tree_map(torch.from_numpy, arrs)
    j_opt = optax.adam(3e-3, **kw)
    t_init, t_update = optim.adam(3e-3, **kw)
    js, ts = j_opt.init(jp), t_init(tp)
    for _ in range(5):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-2, arrs)
        ju, js = j_opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = t_update(tree_map(torch.from_numpy, g), ts, tp)
        tp = optim.apply_updates(tp, tu)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for got, want in zip(tree_leaves(ts["nu"]), jax.tree.leaves(js[0].nu)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)


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
    (["--attn", "ring"], "Queue 1 item 3"),
    (["--attn", "ulysses"], "Queue 1 item 3"),
    (["--shards", "2"], "Queue 1 item 3"),
    (["--sp-engine", "flash"], "Queue 1 item 3"),
    (["--fake-devices", "4"], "Queue 1 item 3"),
    (["--pp-stages", "2"], "Queue 1 item 9"),
    (["--fsdp"], "Queue 1 item 9"),
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
                 ["--generate", "1020"], ["--steps", "0"]):
        assert jlm.main(argv) == 2
        want = capsys.readouterr().err
        assert lm.main(argv + ["--device", "cpu"]) == 2
        assert capsys.readouterr().err == want
