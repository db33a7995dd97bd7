"""The port's sharded-tree checkpoints against the JAX package's, on the CPU.

A checkpoint written by either package loads bit-exact in the other (the
same ``MANIFEST.json``, the same ``shard_NNN.genGGGGGGGG.npz`` files, the
same key layout); a load re-deals the leaves onto N/2, 2N and 1 slots, bit
for bit; a save killed mid-shard or before its manifest commit leaves the
last good tree loading; a torn, pruned or foreign directory raises the JAX
package's ``ValueError``.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch

from cuda_mpi_gpu_cluster_programming_tpu.utils import checkpoint as jckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch.parallel.mesh import make_mesh
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils import checkpoint as tckpt
from cuda_mpi_gpu_cluster_programming_tpu_torch.utils.tree import tree_leaves, tree_paths


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"conv1": {"w": rng.standard_normal((11, 11, 3, 8)).astype(np.float32),
                      "b": rng.standard_normal(8).astype(np.float32)},
            "conv2": {"w": rng.standard_normal((5, 5, 8, 16)).astype(np.float32),
                      "b": np.array([np.nan, -0.0, np.inf, 1e-40] * 4, np.float32)},  # bits, not values
            "layers": [rng.integers(0, 9, 5).astype(np.int32), rng.random((2, 3)).astype(np.float64)]}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _bits_equal(a_tree, b_tree) -> bool:
    a = [(p, np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)) for p, v in tree_paths(a_tree)]
    b = [(p, np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)) for p, v in tree_paths(b_tree)]
    return [p for p, _ in a] == [p for p, _ in b] and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes() for (_, x), (_, y) in zip(a, b))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_either_package_loads_the_others_checkpoint_bit_exact(n_shards, tmp_path):
    tree = _tree()
    jckpt.save_tree_sharded(tmp_path / "j", tree, n_shards=n_shards, meta={"step": 7})
    got, meta = tckpt.load_tree_sharded(tmp_path / "j")
    assert _bits_equal(got, tree) and meta == {"step": 7}
    assert tckpt.shard_layout(tmp_path / "j") == jckpt.shard_layout(tmp_path / "j")
    tckpt.save_tree_sharded(tmp_path / "t", _torch(tree), n_shards=n_shards, meta={"step": 7})
    back, jmeta = jckpt.load_tree_sharded(tmp_path / "t", as_jax=False)
    assert _bits_equal(back, tree) and jmeta == {"step": 7}
    assert json.loads((tmp_path / "t" / "MANIFEST.json").read_text()) == \
        json.loads((tmp_path / "j" / "MANIFEST.json").read_text())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(p.name for p in (tmp_path / "j").iterdir())


def test_a_jax_train_state_loads_in_the_port_and_back(tmp_path):
    params = {k: v for k, v in _tree(1).items() if k != "layers"}
    opt = optax.sgd(1e-3)
    jckpt.save_train_state_sharded(tmp_path / "j", params, opt.init(params), 12, n_shards=3)
    like = _torch(params)
    p, o, step = tckpt.load_train_state_sharded(tmp_path / "j", like, (), device="cpu")
    assert step == 12 and o == () and _bits_equal(p, params)
    tckpt.save_train_state_sharded(tmp_path / "t", p, o, 13, n_shards=2)
    jp, jo, jstep = jckpt.load_train_state_sharded(tmp_path / "t", params, opt.init(params))
    assert jstep == 13 and _bits_equal(jax.tree.map(np.asarray, jp), params)


@pytest.mark.parametrize("saved,target", [(4, 2), (4, 8), (4, 1), (2, 4)])
def test_reshard_on_load_is_bit_exact(saved, target, tmp_path):
    tree = _torch(_tree(2))
    tckpt.save_tree_sharded(tmp_path, tree, n_shards=saved)
    got, _ = tckpt.load_tree_sharded(tmp_path, like=tree, target_shards=target, device="cpu")
    assert _bits_equal(got, tree)
    assert {str(t.device) for t in tree_leaves(got)} == {"cpu"}
    mesh = make_mesh(target, device="cpu")
    tckpt.save_train_state_sharded(tmp_path / "st", tree, (), 5, n_shards=saved)
    p, o, s = tckpt.load_train_state_sharded(tmp_path / "st", tree, (), mesh=mesh)
    assert s == 5 and _bits_equal(p, tree)


def test_a_kill_mid_shard_or_before_the_manifest_keeps_the_last_good_tree(tmp_path, monkeypatch):
    good, newer = _torch(_tree(3)), _torch(_tree(4))
    tckpt.save_tree_sharded(tmp_path, good, n_shards=3, meta={"gen": "good"})
    real_savez, calls = np.savez, []

    def dying_savez(fh, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise KeyboardInterrupt("killed mid-shard")
        real_savez(fh, **kw)

    monkeypatch.setattr(tckpt.np, "savez", dying_savez)
    with pytest.raises(KeyboardInterrupt):
        tckpt.save_tree_sharded(tmp_path, newer, n_shards=3)
    monkeypatch.setattr(tckpt.np, "savez", real_savez)
    got, meta = tckpt.load_tree_sharded(tmp_path)
    assert meta == {"gen": "good"} and _bits_equal(got, good)

    def dying_commit(path, text):
        raise KeyboardInterrupt("killed before the manifest commit")

    monkeypatch.setattr(tckpt, "atomic_write_text", dying_commit)
    with pytest.raises(KeyboardInterrupt):
        tckpt.save_tree_sharded(tmp_path, newer, n_shards=2)
    monkeypatch.undo()
    got, meta = tckpt.load_tree_sharded(tmp_path)
    assert meta == {"gen": "good"} and _bits_equal(got, good)
    jgot, _ = jckpt.load_tree_sharded(tmp_path, as_jax=False)  # the JAX package reads the same last good tree
    assert _bits_equal(jgot, good)
    # the next committed save supersedes it and collects the stale generations
    tckpt.save_tree_sharded(tmp_path, newer, n_shards=2)
    assert _bits_equal(tckpt.load_tree_sharded(tmp_path)[0], newer)
    assert len(list(tmp_path.glob("shard_*.npz"))) == 2


def test_torn_and_foreign_directories_raise_the_jax_packages_errors(tmp_path):
    tree = _torch(_tree(5))

    def both(path):
        with pytest.raises(ValueError) as t:
            tckpt.load_tree_sharded(path)
        with pytest.raises(ValueError) as j:
            jckpt.load_tree_sharded(path, as_jax=False)
        return str(t.value).split(" (")[0], str(j.value).split(" (")[0]

    tckpt.save_tree_sharded(tmp_path / "m", tree, n_shards=2)
    (tmp_path / "m" / "MANIFEST.json").write_text("{torn")
    t, j = both(tmp_path / "m")
    assert t == j and "manifest" in t
    tckpt.save_tree_sharded(tmp_path / "s", tree, n_shards=2)
    shard = next((tmp_path / "s").glob("shard_001.*"))
    shard.write_bytes(shard.read_bytes()[:40])
    t, j = both(tmp_path / "s")
    assert t == j and "truncated or corrupt" in t
    tckpt.save_tree_sharded(tmp_path / "p", tree, n_shards=3)
    next((tmp_path / "p").glob("shard_002.*")).unlink()
    t, j = both(tmp_path / "p")
    assert t == j and "missing" in str(pytest.raises(ValueError, tckpt.load_tree_sharded, tmp_path / "p").value)
    tckpt.save_tree_sharded(tmp_path / "o", tree, n_shards=2)
    f0, f1 = sorted((tmp_path / "o").glob("shard_*.npz"))
    f1.write_bytes(f0.read_bytes())  # a foreign save: the same leaves in two shards
    t, j = both(tmp_path / "o")
    assert t == j and "more than one shard file" in t
    with pytest.raises(FileNotFoundError):
        tckpt.load_tree_sharded(tmp_path / "nowhere")
    with pytest.raises(KeyError):
        tckpt.load_tree_sharded(_save(tmp_path / "k", tree), like={"missing": tree})


def _save(path, tree):
    tckpt.save_tree_sharded(path, tree, n_shards=2)
    return path
