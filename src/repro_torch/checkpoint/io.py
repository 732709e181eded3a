"""Tree checkpoints: npz tensors and json metadata (counterpart of
``repro/checkpoint/io.py``, in the same format).

Keys are the tree's paths joined by ``/``, in sorted-key order, so files
written by either package load in the other. npz holds native numpy
dtypes only: a bfloat16 leaf is stored as its uint16 view beside a
``<key>::dtype`` entry naming the type (the reference's convention for
non-native dtypes, which ``load`` reads for any 1- or 2-byte type), and
converted back with torch.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree

_VIEW = {1: np.uint8, 2: np.int16}     # same-width views torch can read


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> tuple:
    """(array, dtype name or None for a native dtype)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _flatten(tree_) -> Dict[str, np.ndarray]:
    flat = {}
    paths, leaves = tree.flatten(tree_)
    for path, leaf in zip(paths, leaves):
        arr, dtype = _to_numpy(leaf)
        if dtype is not None:
            flat[_key(path) + "::dtype"] = np.array(dtype)
        flat[_key(path)] = arr
    return flat


def save(path: str, tree_, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **_flatten(tree_))
    with open(path + ".json", "w") as f:
        json.dump(metadata or {}, f, indent=2, default=str)


def _to_tensor(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype is None:
        return torch.from_numpy(np.array(arr))
    tdt = getattr(torch, dtype)
    return torch.from_numpy(np.array(arr).view(_VIEW[tdt.itemsize])).view(tdt)


def load(path: str, like) -> Any:
    """Restore into the structure of ``like`` (a tree with the same
    paths; its leaves are not read): a tree of CPU tensors. A path
    missing from the file raises KeyError."""
    with np.load(path + ".npz") as data:
        paths = tree.flatten(like)[0]
        leaves = []
        for p in paths:
            k = _key(p)
            dtype = str(data[k + "::dtype"]) if k + "::dtype" in data else None
            leaves.append(_to_tensor(data[k], dtype))
    return tree.unflatten(paths, leaves)


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)
