"""Params checkpoints as one npz archive: the npz format of the JAX
package's ``utils/checkpoint.py``.

Keys are the tree's paths joined by '/' (``layers/0/wqkv``); lists come
back from their integer keys. A file written by either package loads in
the other, bit for bit. The write is atomic (``resilience/journal.
atomic_open``: tmp file, fsync, rename), so a crash mid-save leaves the
previous checkpoint whole, and a truncated or corrupt archive raises
``ValueError`` on load. The sharded and orbax formats are not ported
(ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..resilience.journal import atomic_open
from .tree import tree_map, tree_paths, tree_unflatten


def _array(path: str, leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(f"leaf {path!r} is bfloat16, which numpy's npz cannot hold: save the fp32 masters")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_params_npz(path: str | Path, params: Any) -> Path:
    """Save a nested dict/list of tensors to one .npz file, bit-exact and atomic."""
    path = Path(path)
    flat = {key: _array(key, leaf) for key, leaf in tree_paths(params)}
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
