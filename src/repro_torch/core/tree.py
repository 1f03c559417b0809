"""Trees of tensors: nested dicts, lists and tuples whose leaves are
tensors (or any other object, such as a ``WirePayload``).

``tree_map`` keeps a tree's structure and insertion order. ``leaf_paths``
and ``flatten`` number the leaves as ``jax.tree.leaves`` does: dict keys
sorted, list and tuple items in order. The replica step's noise contract
numbers leaves in that order (``distributed.netes_dist``).
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree``, zipped with trees ``rest`` of
    the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaf_paths(tree: Any, prefix: Tuple = ()) -> List[Tuple]:
    """The paths of ``tree``'s leaves, dict keys sorted, list items in
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k],
                                                            prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, prefix + (i,))]
    return [prefix]


def flatten(tree: Any) -> List[Any]:
    """``tree``'s leaves in ``leaf_paths`` order."""
    out = []
    for path in leaf_paths(tree):
        node = tree
        for k in path:
            node = node[k]
        out.append(node)
    return out
