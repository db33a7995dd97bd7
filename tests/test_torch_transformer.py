"""The port's transformer LM (forward, loss, KV-cache decode, generation)
and long-context CLI against the JAX package's (training: test_torch_train.py).

Both packages run on the CPU with the same weights: the JAX package's
``init_transformer`` tree, carried over by ``lm_params_from_jax``. The
port's flash attention runs the plain version of its kernel on the CPU,
the JAX package's its Pallas kernel in interpret mode.

Tolerance: rtol 1e-4 / atol 2e-4 on fp32 logits, as ``tests/test_decode.py``
holds the decode path to ``forward_lm``: the matmuls and softmaxes sum in
other orders in the two frameworks, and the residual stream carries those
differences through every layer. bf16: rtol 0.1 / atol 0.3, that file's bf16
parity tolerance (bf16 rounds at other points in the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.models import transformer as jtf
from cuda_mpi_gpu_cluster_programming_tpu_torch.examples import lm, long_context
from cuda_mpi_gpu_cluster_programming_tpu_torch.models import transformer as ttf

# tests/test_decode.py's config
CFG = jtf.TransformerConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=96)
TCFG = ttf.TransformerConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=96)
# top-1 MoE whose capacity (int(0.5 * 80 / 4) = 10 slots an expert for 80 tokens) drops tokens
MOE_KW = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_len=64, n_experts=4, capacity_factor=0.5)
RTOL, ATOL = 1e-4, 2e-4


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(jcfg, **over):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(ttf.TransformerConfig)}
    return ttf.TransformerConfig(**{**fields, **over})


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def dense():
    jparams = jtf.init_transformer(jax.random.PRNGKey(0), CFG)
    return jparams, ttf.lm_params_from_jax(_tree_np(jparams), device="cpu"), _tokens((2, 40), CFG.vocab, 0)


@pytest.fixture(scope="module")
def moe():
    jcfg = jtf.TransformerConfig(**MOE_KW)
    jparams = jtf.init_transformer(jax.random.PRNGKey(3), jcfg)
    return jcfg, jparams, ttf.lm_params_from_jax(_tree_np(jparams), device="cpu"), _tokens((2, 40), jcfg.vocab, 3)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_lm_params_from_jax_round_trip(dtype):
    jparams = jtf.init_transformer(jax.random.PRNGKey(1), CFG)
    if dtype == "bf16":
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    tree = _tree_np(jparams)
    params = ttf.lm_params_from_jax(tree, device="cpu")
    flat_j, def_j = jax.tree.flatten(tree)
    flat_t, def_t = jax.tree.flatten(params)
    assert def_j == def_t
    assert params["layers"][0]["wqkv"].shape == (64, 3, 64)
    for a, t in zip(flat_j, flat_t):
        assert t.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32) and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("n_experts", [0, 4])
def test_init_transformer_has_the_jax_layout_and_scales(n_experts):
    jcfg = dataclasses.replace(CFG, n_experts=n_experts)
    want = _tree_np(jtf.init_transformer(jax.random.PRNGKey(0), jcfg))
    got = ttf.init_transformer(_port_cfg(jcfg), generator=torch.Generator().manual_seed(0), device="cpu")
    flat_j, def_j = jax.tree.flatten(want)
    flat_t, def_t = jax.tree.flatten(got)
    assert def_j == def_t
    assert [a.shape for a in flat_j] == [tuple(t.shape) for t in flat_t]
    # the same scaled-normal distributions: std 1/sqrt(fan_in) (x 0.02 for pos)
    assert abs(float(got["embed"].std()) - 1.0) < 0.05
    assert abs(float(got["pos"].std()) - 0.02) < 0.002
    assert abs(float(got["layers"][0]["wqkv"].std()) * 8.0 - 1.0) < 0.05


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_forward_lm_matches_jax(dense, impl):
    jparams, params, toks = dense
    want = jtf.forward_lm(jparams, jnp.asarray(toks), dataclasses.replace(CFG, attn_impl=impl))
    got = ttf.forward_lm(params, torch.from_numpy(toks), _port_cfg(CFG, attn_impl=impl))
    assert got.shape == (2, 40, CFG.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_forward_lm_bf16_matches_jax(dense):
    jparams, _, toks = dense
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    params = ttf.lm_params_from_jax(_tree_np(jb), device="cpu")
    want = jtf.forward_lm(jb, jnp.asarray(toks), dataclasses.replace(CFG, attn_impl="flash"))
    got = ttf.forward_lm(params, torch.from_numpy(toks), _port_cfg(CFG, attn_impl="flash"))
    assert got.dtype == torch.bfloat16
    _close(got, want, rtol=0.1, atol=0.3)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_moe_forward_and_aux_match_jax_with_drops(moe, impl):
    jcfg, jparams, params, toks = moe
    tcfg = _port_cfg(jcfg, attn_impl=impl)
    want, want_aux = jtf.forward_lm(jparams, jnp.asarray(toks), dataclasses.replace(jcfg, attn_impl=impl),
                                    return_aux=True)
    got, aux = ttf.forward_lm(params, torch.from_numpy(toks), tcfg, return_aux=True)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    # the capacity dropped tokens: an undroppable capacity changes the logits
    roomy = ttf.forward_lm(params, torch.from_numpy(toks), dataclasses.replace(tcfg, capacity_factor=16.0))
    assert float((roomy - got).abs().max()) > 1e-3


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_lm_loss_matches_jax(dense, moe, which):
    if which == "dense":
        jparams, params, toks = dense
        jcfg = CFG
    else:
        jcfg, jparams, params, toks = moe
    want = float(jtf.lm_loss(jparams, jnp.asarray(toks), jcfg))
    got = ttf.lm_loss(params, torch.from_numpy(toks), _port_cfg(jcfg))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    flash = ttf.lm_loss(params, torch.from_numpy(toks), _port_cfg(jcfg, attn_impl="flash"))
    np.testing.assert_allclose(float(flash), want, rtol=1e-5)


def test_decode_logits_matches_jax_and_forward(dense):
    jparams, params, toks = dense
    got = ttf.decode_logits(params, torch.from_numpy(toks), TCFG)
    assert got.shape == (2, 40, CFG.vocab) and got.dtype == torch.float32
    _close(got, jtf.decode_logits(jparams, jnp.asarray(toks), CFG))
    _close(got, ttf.forward_lm(params, torch.from_numpy(toks), TCFG))


def test_moe_decode_matches_jax(moe):
    jcfg, jparams, params, toks = moe
    got = ttf.decode_logits(params, torch.from_numpy(toks), _port_cfg(jcfg))
    _close(got, jtf.decode_logits(jparams, jnp.asarray(toks), jcfg))
    # capacity-infinite serving equals the forward whenever training would drop nothing
    roomy = _port_cfg(jcfg, capacity_factor=16.0)
    _close(got, ttf.forward_lm(params, torch.from_numpy(toks), roomy))


def test_decode_leaves_the_input_cache_as_it_was(dense):
    # as it was but for position pos, which the block writes in place: the
    # returned cache is the input one, the same storage, no copy
    _, params, _ = dense
    cache = ttf.init_kv_cache(TCFG, 2, device="cpu")[0]
    ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
    x = torch.randn(2, 1, 64, generator=torch.Generator().manual_seed(0))
    _, new = ttf._decode_block(params["layers"][0], x, cache, 5, TCFG)
    assert new is cache and (new["k"].data_ptr(), new["v"].data_ptr()) == ptrs
    others = torch.cat([cache["k"][:, :5], cache["k"][:, 6:], cache["v"][:, :5], cache["v"][:, 6:]], dim=1)
    assert float(others.abs().max()) == 0.0
    assert float(cache["k"][:, 5].abs().max()) > 0.0 and float(cache["v"][:, 5].abs().max()) > 0.0


def test_decode_writes_the_caches_in_place(dense, monkeypatch):
    # every token step of decode_logits and generate writes into the caches
    # init_kv_cache made, never into a copy, and the parity with forward_lm holds
    _, params, toks = dense
    made, seen = [], []
    init, block = ttf.init_kv_cache, ttf._decode_block

    def init_spy(*a, **k):
        made.extend(init(*a, **k))
        return made[-TCFG.n_layers:]

    def block_spy(layer, x, cache, pos, cfg):
        out, new = block(layer, x, cache, pos, cfg)
        seen.append((pos, new["k"].data_ptr(), new["v"].data_ptr()))
        return out, new

    monkeypatch.setattr(ttf, "init_kv_cache", init_spy)
    monkeypatch.setattr(ttf, "_decode_block", block_spy)
    got = ttf.decode_logits(params, torch.from_numpy(toks), TCFG)
    _close(got, ttf.forward_lm(params, torch.from_numpy(toks), TCFG))
    ptrs = {(c["k"].data_ptr(), c["v"].data_ptr()) for c in made}
    assert len(made) == TCFG.n_layers and len(seen) == TCFG.n_layers * toks.shape[1]
    assert {(k, v) for _pos, k, v in seen} == ptrs
    made.clear(), seen.clear()
    seq = ttf.generate(params, torch.from_numpy(toks[:, :8]), TCFG, steps=4)
    assert seq.shape == (2, 12) and {(k, v) for _pos, k, v in seen} == {
        (c["k"].data_ptr(), c["v"].data_ptr()) for c in made}


def test_greedy_generate_matches_jax(dense):
    jparams, params, toks = dense
    prompt = toks[:, :8]
    want = np.asarray(jtf.generate(jparams, jnp.asarray(prompt), CFG, steps=12))
    got = ttf.generate(params, torch.from_numpy(prompt), TCFG, steps=12)
    assert got.shape == (2, 20) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_moe_greedy_generate_matches_jax(moe):
    jcfg, jparams, params, toks = moe
    want = np.asarray(jtf.generate(jparams, jnp.asarray(toks[:, :8]), jcfg, steps=6))
    got = ttf.generate(params, torch.from_numpy(toks[:, :8]), _port_cfg(jcfg), steps=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_and_guards(dense):
    _, params, toks = dense
    prompt = torch.from_numpy(toks[:, :8])
    seq = ttf.generate(params, prompt, TCFG, steps=4, temperature=0.8, generator=torch.Generator().manual_seed(1))
    assert seq.shape == (2, 12) and int(seq.min()) >= 0 and int(seq.max()) < TCFG.vocab
    assert torch.equal(seq[:, :8], prompt.long())
    again = ttf.generate(params, prompt, TCFG, steps=4, temperature=0.8, generator=torch.Generator().manual_seed(1))
    assert torch.equal(seq, again)
    with pytest.raises(ValueError, match="needs an explicit generator"):
        ttf.generate(params, prompt, TCFG, steps=2, temperature=0.5)
    with pytest.raises(ValueError, match="steps"):
        ttf.generate(params, prompt, TCFG, steps=0)
    with pytest.raises(ValueError, match="max_len"):
        ttf.generate(params, torch.from_numpy(toks), TCFG, steps=TCFG.max_len)


def test_transformer_lm_module_owns_the_params(dense):
    _, params, toks = dense
    model = ttf.TransformerLM(params, _port_cfg(CFG, attn_impl="flash"))
    names = {n for n, _ in model.named_parameters()}
    assert {"embed", "pos", "final_norm.g", "layers.0.wqkv", "layers.1.w_down", "layers.0.attn_norm.g"} <= names
    assert sum(p.numel() for p in model.parameters()) == sum(t.numel() for t in jax.tree.leaves(params))
    want = ttf.forward_lm(params, torch.from_numpy(toks), _port_cfg(CFG, attn_impl="flash"))
    with torch.no_grad():
        assert torch.equal(model(torch.from_numpy(toks)), want)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_name_the_roadmap_item(dense, impl):
    _, params, toks = dense
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ttf.forward_lm(params, torch.from_numpy(toks), _port_cfg(CFG, attn_impl=impl))
    with pytest.raises(ValueError, match="attn_engine"):
        ttf.TransformerConfig(attn_engine="xla")


@pytest.mark.parametrize("strategy,dtype", [("single", "fp32"), ("flash", "fp32"), ("flash", "bf16")])
def test_long_context_cli_on_the_cpu(capsys, strategy, dtype):
    argv = ["--strategy", strategy, "--verify", "--device", "cpu", "--seq-len", "256", "--heads", "2",
            "--head-dim", "32", "--dtype", dtype, "--repeats", "2", "--warmup", "1"]
    assert long_context.main(argv) == 0
    out = capsys.readouterr().out
    assert "KV resident per device: 256 tokens x 2 heads" in out
    assert "Final Output Shape: 1x256x2x32" in out
    assert len(out.split("Final Output (first 10 values): ")[1].splitlines()[0].split()) == 10
    assert "Attention completed in " in out and " tok/s)" in out
    assert "-> PASSED" in out


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_long_context_sequence_parallel_exits_2(capsys, strategy):
    assert long_context.main(["--strategy", strategy, "--device", "cpu"]) == 2
    captured = capsys.readouterr()
    assert "Queue 1 item 3" in captured.err and captured.out == ""


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        long_context.main(["--strategy", "flash", "--seq-len", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_transformer(TCFG, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main(["--attn", "flash", "--steps", "1"])
