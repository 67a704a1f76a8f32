"""Nested dicts of tensors (the port's parameter, gradient and optimizer
trees): the few `jax.tree` operations the training slice needs. Leaves
come in sorted-key order, so two trees of the same structure line up
leaf for leaf."""

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)

