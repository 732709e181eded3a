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


def unflatten(paths, leaves) -> dict:
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn, tree):
    paths, leaves = flatten(tree)
    return unflatten(paths, [fn(x) for x in leaves])


def leaves(tree) -> list:
    return flatten(tree)[1]
