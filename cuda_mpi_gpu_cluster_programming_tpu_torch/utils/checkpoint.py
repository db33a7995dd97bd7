"""Checkpoints in the JAX package's formats (``utils/checkpoint.py``).

- **npz**: one archive of the tree, keys its paths joined by '/'
  (``layers/0/wqkv``); lists come back from their integer keys.
  :func:`save_train_state` writes the training state (params, optimizer
  state, step) as one such archive.
- **sharded tree** (:func:`save_tree_sharded`, :func:`load_tree_sharded`):
  the sorted keys dealt round-robin over N shard files
  (``shard_NNN.genGGGGGGGG.npz``), each written atomically, then a
  ``MANIFEST.json`` naming exactly that file set, replaced atomically LAST
  (the commit point), then the superseded generations deleted. A kill at
  any instant leaves the manifest naming a whole generation, so the last
  good tree always loads. The manifest lists the keys, so which shard
  holds which leaf follows from it alone (:func:`shard_layout`), and a
  load re-deals the leaves onto any shard count: ``target_shards=`` or
  ``mesh=`` reassemble an n-way checkpoint bit for bit onto n/2, 2n or 1
  slots (the restore side of ``parallel.elastic``).

A file written by either package loads in the other, bit for bit. Every
write is atomic (``resilience/journal.atomic_open``: tmp file, fsync,
rename), and a truncated or corrupt archive or manifest raises
``ValueError`` on load, so a rollback catches one exception type. The
JAX package's orbax format is not ported (the card's machine has no orbax,
and the sharded tree covers what it is used for).
"""

from __future__ import annotations

import contextlib
import json
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..resilience.journal import atomic_open, atomic_write_text
from .tree import tree_map, tree_paths, tree_unflatten


def _array(path: str, leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"leaf {path!r} is bfloat16, which numpy's npz cannot hold: save the fp32 masters")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


MANIFEST_NAME = "MANIFEST.json"


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _array(key, leaf) for key, leaf in tree_paths(tree)}


def save_params_npz(path: str | Path, params: Any) -> Path:
    """Save a nested dict/list of tensors to one .npz file, bit-exact and atomic."""
    path = Path(path)
    flat = _flatten(params)
    with atomic_open(path, "wb") as fh:
        np.savez(fh, **flat)
    return path


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _lists_from_int_dicts(tree)


def _lists_from_int_dicts(node: Any) -> Any:
    """A dict whose keys are exactly '0'..'n-1' was a list before flattening."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists_from_int_dicts(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        idx = sorted(int(k) for k in node)
        if idx == list(range(len(node))):
            return [node[str(i)] for i in idx]
    return node


def load_params_npz(path: str | Path, like: Optional[Any] = None) -> Any:
    """Load an npz checkpoint as a tree of tensors.

    Without ``like``, the dict/list structure comes from the key paths and
    the tensors lie on the CPU. With ``like`` (a tree of the saved
    structure, e.g. freshly initialised params), the leaves come back in
    exactly that structure, each on its ``like`` leaf's device; a leaf the
    archive lacks raises ``KeyError``. Dtypes are the archive's.

    A truncated or otherwise corrupt archive raises ``ValueError`` with the
    path in the message."""
    try:
        with np.load(Path(path)) as archive:
            flat = {k: archive[k] for k in archive.files}
    except (zipfile.BadZipFile, EOFError, OSError) as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise ValueError(
            f"checkpoint {path} is truncated or corrupt ({type(e).__name__}: {e}); "
            "it was not written by the atomic saver or the medium is failing"
        ) from e
    if like is None:
        return tree_map(torch.from_numpy, _unflatten(flat))
    leaves = []
    for key, want in tree_paths(like):
        if key not in flat:
            raise KeyError(f"checkpoint {path} has no leaf {key!r}")
        t = torch.from_numpy(flat[key])
        leaves.append(t.to(want.device) if isinstance(want, torch.Tensor) else t)
    return tree_unflatten(like, leaves)


def save_train_state(path: str | Path, params: Any, opt_state: Any, step: int) -> Path:
    """The training state in one atomic npz: params, optimizer state and
    the step they are valid at (``step`` updates applied), keys
    ``params/...``, ``opt_state/...`` and ``step``: the last-good state a
    sentinel rollback restores."""
    return save_params_npz(path, {"params": params, "opt_state": opt_state, "step": np.asarray(step, np.int64)})


def load_train_state(path: str | Path, like_params: Any, like_opt_state: Any) -> Tuple[Any, Any, int]:
    """``(params, opt_state, step)`` from :func:`save_train_state`, in
    exactly the given structures, each leaf on its ``like`` leaf's device.
    A truncated or corrupt file raises ``ValueError``, a missing leaf
    ``KeyError``."""
    like = {"params": like_params, "opt_state": like_opt_state, "step": np.zeros((), np.int64)}
    tree = load_params_npz(path, like=like)
    return tree["params"], tree["opt_state"], int(tree["step"])


def _read_npz(path: Path, what: str) -> Dict[str, np.ndarray]:
    try:
        with np.load(path) as archive:
            return {k: archive[k] for k in archive.files}
    except (zipfile.BadZipFile, EOFError, OSError) as e:
        if isinstance(e, FileNotFoundError):
            raise
        raise ValueError(f"{what} {path} is truncated or corrupt ({type(e).__name__}: {e}); "
                         "the manifest-commit saver cannot produce this — suspect the medium") from e


def _from_flat(flat: Dict[str, np.ndarray], like: Optional[Any], source) -> Any:
    """The flat archive as a tree of tensors on the CPU: ``like``'s
    structure (a leaf it names but ``flat`` lacks raises ``KeyError``), or
    the structure of the key paths."""
    if like is None:
        return tree_map(torch.from_numpy, _unflatten(flat))
    leaves = []
    for key, _ in tree_paths(like):
        if key not in flat:
            raise KeyError(f"sharded checkpoint {source} has no leaf {key!r}")
        leaves.append(torch.from_numpy(flat[key]))
    return tree_unflatten(like, leaves)


# ------------------------------------------------- sharded-tree format ---


def _read_manifest(directory: Path) -> dict:
    mpath = directory / MANIFEST_NAME
    if not mpath.exists():
        raise FileNotFoundError(f"no {MANIFEST_NAME} in {directory}")
    try:
        manifest = json.loads(mpath.read_text())
    except ValueError as e:
        raise ValueError(f"sharded checkpoint manifest {mpath} is corrupt ({e}); it was "
                         "not written by the atomic saver or the medium is failing") from e
    if not isinstance(manifest, dict) or not isinstance(manifest.get("files"), list):
        raise ValueError(f"sharded checkpoint manifest {mpath} is malformed")
    return manifest


def save_tree_sharded(directory: str | Path, tree: Any, n_shards: int = 4, meta: Optional[dict] = None) -> Path:
    """Crash-consistent sharded save of ``tree`` into ``directory``: the
    sorted keys dealt round-robin over ``n_shards`` shard files of a new
    generation, each atomic, then the manifest (version 2: the generation,
    the files, the keys, ``meta``) atomically replaced, then the older
    generations deleted."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    keys = sorted(flat)
    n_shards = max(1, int(n_shards))
    gen = 0
    with contextlib.suppress(FileNotFoundError, ValueError):
        gen = int(_read_manifest(directory).get("gen", -1)) + 1
    files = []
    for k in range(n_shards):
        fname = f"shard_{k:03d}.gen{gen:08d}.npz"
        with atomic_open(directory / fname, "wb") as fh:
            np.savez(fh, **{key: flat[key] for key in keys[k::n_shards]})
        files.append(fname)
    atomic_write_text(
        directory / MANIFEST_NAME,
        json.dumps({"version": 2, "gen": gen, "n_shards": n_shards, "files": files, "n_leaves": len(keys),
                    "keys": keys, "meta": meta or {}}, indent=2) + "\n",
    )
    tag = f".gen{gen:08d}.npz"  # post-commit GC: a kill here leaves only unreferenced files
    for old in directory.glob("shard_*.gen*.npz"):
        if not old.name.endswith(tag):
            with contextlib.suppress(OSError):
                old.unlink()
    return directory


def _check_shard_set(directory: Path, manifest: dict) -> None:
    """A manifest that miscounts its files, or names files the directory
    lacks, is a directory problem, not a torn write: say so."""
    files = manifest["files"]
    declared = manifest.get("n_shards")
    if declared is not None and int(declared) != len(files):
        raise ValueError(f"sharded checkpoint manifest {directory / MANIFEST_NAME} is malformed: declares "
                         f"n_shards={declared} but names {len(files)} shard files")
    missing = sorted(f for f in files if not (directory / f).is_file())
    if missing:
        raise ValueError(
            f"sharded checkpoint {directory}: manifest declares n_shards="
            f"{declared if declared is not None else len(files)} ({len(files)} shard files) but "
            f"{len(missing)} are missing ({', '.join(missing)}) — the directory was pruned outside the saver "
            "(post-commit GC only deletes superseded generations); restore the files or fall back to an older "
            "checkpoint"
        )


def load_tree_sharded(directory: str | Path, like: Optional[Any] = None, *, target_shards: Optional[int] = None,
                      mesh=None, device: str = "cuda") -> Tuple[Any, dict]:
    """The last good sharded tree and its ``meta``: ``(tree, meta)``.

    Only the files the manifest names are read. The leaves come back as
    tensors in ``like``'s structure, or the key paths'; on the CPU, or,
    with ``mesh=`` (a ``parallel.mesh.Mesh``) or ``target_shards=N`` (a
    fresh N-slot mesh on ``device``), on that mesh's home device: the
    reshard-on-load. The values are the saved bits whatever the shard
    count. A missing shard file, a leaf in two shards, a leaf count off the
    manifest's, or a corrupt file raise ``ValueError``."""
    directory = Path(directory)
    manifest = _read_manifest(directory)
    _check_shard_set(directory, manifest)
    flat: Dict[str, np.ndarray] = {}
    for fname in manifest["files"]:
        for k, v in _read_npz(directory / fname, "sharded checkpoint shard").items():
            if k in flat:
                raise ValueError(f"sharded checkpoint {directory}: leaf {k!r} appears in more than one shard file "
                                 "— extra/overlapping shard content the round-robin saver cannot produce; the "
                                 "directory holds files from a foreign save")
            flat[k] = v
    if manifest.get("n_leaves") not in (None, len(flat)):
        raise ValueError(f"sharded checkpoint {directory} holds {len(flat)} leaves, manifest promises "
                         f"{manifest['n_leaves']}")
    tree = _from_flat(flat, like, directory)
    if mesh is None and target_shards is not None:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(int(target_shards), device=device)
    if mesh is not None:
        from ..parallel.elastic import reshard_tree

        tree = reshard_tree(tree, mesh)
    return tree, manifest.get("meta", {})


def shard_layout(directory: str | Path) -> Dict[str, str]:
    """Every leaf key to the shard file holding it, from the manifest alone
    (key j of the sorted keys in shard ``j % n_shards``); no shard file is
    opened."""
    directory = Path(directory)
    manifest = _read_manifest(directory)
    keys = manifest.get("keys")
    if keys is None:
        raise ValueError(f"sharded checkpoint manifest in {directory} predates the derivable-layout format (no "
                         f"'keys' field; version {manifest.get('version')}) — re-save to upgrade")
    files = manifest["files"]
    return {key: files[j % len(files)] for j, key in enumerate(keys)}


def save_train_state_sharded(directory: str | Path, params: Any, opt_state: Any, step: int,
                             n_shards: int = 4) -> Path:
    """The training state (params, optimizer state, the step they are valid
    at) as a sharded tree, ``meta`` ``{"step": step}``."""
    return save_tree_sharded(directory, {"params": params, "opt_state": opt_state,
                                         "step": np.asarray(step, np.int64)},
                             n_shards=n_shards, meta={"step": int(step)})


def load_train_state_sharded(directory: str | Path, like_params: Any, like_opt_state: Any, *,
                             target_shards: Optional[int] = None, mesh=None,
                             device: str = "cuda") -> Tuple[Any, Any, int]:
    """``(params, opt_state, step)`` from :func:`save_train_state_sharded`,
    in exactly the given structures; ``target_shards=``/``mesh=`` place
    them on another slot count's mesh, bit for bit."""
    like = {"params": like_params, "opt_state": like_opt_state, "step": np.zeros((), np.int64)}
    tree, _meta = load_tree_sharded(directory, like=like, target_shards=target_shards, mesh=mesh, device=device)
    return tree["params"], tree["opt_state"], int(tree["step"])
