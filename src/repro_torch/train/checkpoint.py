"""Checkpoints in the JAX package's layout (counterpart of
``repro.train.checkpoint``), so that either package loads the other's.

    <dir>/step_<N:08d>/arrays.npz + manifest.json

Each leaf is stored under its key path as the JAX package names it: the
keys and indices from the root joined by "/", a dataclass field as
``.name`` (a ``TrainState`` gives ``.params/embed``,
``.params/groups/0/b0/ffn/w_down``, ``.opt_state/m/...`` and ``.step``).
bf16 is stored as its ``uint16`` bits with a dtype tag in the manifest.
The arrays are written uncompressed (``np.savez``; the JAX package
compresses, and ``np.load`` reads either): a model of billions of
parameters would spend minutes in zlib.
"""

from __future__ import annotations

import dataclasses
import json
import os
import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_paths, tree_unflatten


def _paths(tree):
    """(key path, leaf) pairs in leaf order; dataclass fields as
    ``.name``, in field order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            for path, leaf in _paths(getattr(tree, f.name)):
                yield (f".{f.name}/{path}" if path else f".{f.name}"), leaf
    else:
        yield from tree_paths(tree)


def save_checkpoint(tree, directory: str, step: int) -> str:
    """Write ``tree`` (a tree of tensors, or a dataclass of such trees such
    as ``TrainState``) as step ``step`` under ``directory``; returns the
    step's path."""
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    arrays, meta = {}, {}
    for k, v in _paths(tree):
        t = torch.as_tensor(v).detach().cpu()
        if t.dtype == torch.bfloat16:
            arrays[k] = t.view(torch.int16).numpy().view(np.uint16)
            meta[k] = {"dtype": "bfloat16", "shape": list(t.shape)}
        else:
            arrays[k] = t.numpy()
            meta[k] = {"dtype": str(arrays[k].dtype), "shape": list(t.shape)}
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": meta}, f, indent=1)
    return path


def _rebuild(tree_like, leaves):
    """``tree_like``'s structure (dataclasses field by field) over
    ``leaves`` in ``_paths`` order."""
    if dataclasses.is_dataclass(tree_like) and not isinstance(tree_like,
                                                               type):
        return dataclasses.replace(tree_like, **{
            f.name: _rebuild(getattr(tree_like, f.name), leaves)
            for f in dataclasses.fields(tree_like)})
    flat, treedef = tree_flatten(tree_like)
    return tree_unflatten(treedef, [next(leaves) for _ in flat])


def load_checkpoint(tree_like, directory: str, step: int = -1):
    """Restore into the structure of ``tree_like`` (each leaf's shape,
    dtype and device taken from it); ``step=-1`` takes the latest.
    Returns ``(tree, step)``."""
    if step < 0:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                       if d.startswith("step_"))
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    leaves = []
    for key, like in _paths(tree_like):
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = data[key]
        if manifest["leaves"][key]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        like = torch.as_tensor(like)
        leaves.append(t.reshape(like.shape).to(like.dtype).to(like.device))
    return _rebuild(tree_like, iter(leaves)), manifest["step"]
