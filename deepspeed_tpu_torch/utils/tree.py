"""Nested dicts and lists of tensors (the port's parameter, gradient and
optimizer trees, and the serving layout's list of layers): the few
`jax.tree` operations the port needs. Leaves come in sorted-key order,
so two trees of the same structure line up leaf for leaf; anything that
is not a dict, list or tuple (a tensor, a quantized weight) is a leaf."""

from typing import Any, Callable, List


def leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in leaves(x)]
    return [tree]


def tree_map_with_path(fn: Callable, tree: Any, path: str = "") -> Any:
    """fn(path, leaf) over the tree; paths join keys and list indices with
    '/'."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable, tree: Any) -> Any:
    return tree_map_with_path(lambda _, x: fn(x), tree)
