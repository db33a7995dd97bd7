"""Nested params: dicts, lists and tuples of tensors (the JAX package's pytrees).

Leaves come in JAX's order, dict keys sorted, so ``tree_leaves`` of a port
tree lines up with ``jax.tree.leaves`` of the same JAX tree; a path is the
keys and list indices joined by '/', as the JAX package's npz checkpoints
name their entries.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    by_path = dict(zip((p for p, _ in tree_paths(like)), leaves))
    return _rebuild(like, by_path, ())


def _rebuild(node: Any, by_path: dict, prefix: Tuple[str, ...]) -> Any:
    if isinstance(node, dict):
        return {k: _rebuild(v, by_path, prefix + (str(k),)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, by_path, prefix + (str(i),)) for i, v in enumerate(node))
    return by_path["/".join(prefix)]
