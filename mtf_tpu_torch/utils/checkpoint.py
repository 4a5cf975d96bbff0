"""Checkpoint / resume of tracker states (port of
`mtf_tpu/utils/checkpoint.py`).

A tracker's state is a tree of NamedTuples and tuples of tensors, so a
checkpoint is generic: flatten it (`torch.utils._pytree`), save the
leaves as a `.npz` and the tree's structure beside it as `<path>.tree`
(json), and restore the leaves into the structure of a `like` state, each
on the device and in the dtype of the leaf it replaces.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _leaf_key(i: int) -> str:
    return f"leaf_{i:04d}"


def save_state(path: str, state) -> None:
    """Save a tracker state to `path` (.npz) + `path`.tree (json); its
    leaves are tensors and the `None`s of unset fields, which are not
    saved."""
    leaves, spec = pytree.tree_flatten(state)
    leaves = [x for x in leaves if x is not None]
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    arrays, meta = {}, []
    for i, leaf in enumerate(leaves):
        a = leaf.detach().cpu().numpy()
        arrays[_leaf_key(i)] = a
        meta.append({"dtype": str(a.dtype), "shape": list(a.shape)})
    np.savez(path, **arrays)
    with open(path + ".tree", "w") as f:
        json.dump({"treedef": str(spec), "n_leaves": len(leaves),
                   "meta": meta}, f)


def load_state(path: str, like):
    """Restore a state saved by `save_state`; `like` (an example state of
    the same tracker and batch, e.g. from `initialize` on frame 0) gives
    the structure and each leaf's device and dtype."""
    data = np.load(path if path.endswith(".npz") else path + ".npz"
                   if os.path.exists(path + ".npz") else path,
                   allow_pickle=False)
    leaves_like, spec = pytree.tree_flatten(like)
    n = sum(x is not None for x in leaves_like)
    if len(data.files) != n:
        raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                         f"state needs {n}")
    out, i = [], 0
    for ref in leaves_like:
        if ref is None:
            out.append(None)
            continue
        a = data[_leaf_key(i)]
        i += 1
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {i - 1} has shape "
                             f"{a.shape}, state needs {tuple(ref.shape)}")
        out.append(torch.as_tensor(a).to(device=ref.device, dtype=ref.dtype))
    return pytree.tree_unflatten(out, spec)


def save_fleet(path: str, states) -> None:
    """Fleet checkpoint: same format (batched leaves)."""
    save_state(path, states)


def load_fleet(path: str, like):
    return load_state(path, like)
