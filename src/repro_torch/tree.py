"""Nested dicts of tensors as parameter trees.

The leaf order is the reference's: JAX flattens a dict with its keys
sorted, at every level. The packed layout (``optim/packing.py``), the
bridge from the reference's arrays and parameter init all walk trees in
this one order, so a flat buffer means the same thing in both packages.
"""
from __future__ import annotations

from typing import Any, List, Tuple

Path = Tuple[str, ...]


def flatten(tree) -> Tuple[List[Path], List[Any]]:
    """(paths, leaves) in sorted-key order; a leaf is anything that is
    not a dict."""
    paths, leaves = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            paths.append(path)
            leaves.append(node)

    walk(tree, ())
    return paths, leaves


def unflatten(paths, leaves):
    if list(paths) == [()]:          # the tree was one leaf
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``
    (which have its structure), leaf by leaf."""
    paths, leaves = flatten(tree)
    others = [flatten(t)[1] for t in rest]
    return unflatten(paths, [fn(*xs) for xs in zip(leaves, *others)])


def leaves(tree) -> list:
    return flatten(tree)[1]
