"""Checkpoint and resume: crash-safe persistence of optimisation state.

PyTorch counterpart of ``tracer/checkpoint.py``, in the same file layout: one
``.npz`` holding the leaves of a nested structure of dicts, tuples and
lists (None holds no leaf) as ``leaf_{i}`` in flatten order, dict keys
sorted (the order ``jax.tree_util`` flattens a dict in), plus the user
metadata as JSON bytes under ``__meta__``. A checkpoint written by either
package therefore loads in the other when the two structures flatten to the
same leaves. Writes are atomic (temp file + ``os.replace``), so a kill
mid-write leaves the previous checkpoint intact.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """Leaves in flatten order: dict values by sorted key, tuple and list
    items in order, None skipped."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [l for x in tree for l in tree_leaves(x)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like, leaves: list):
    """``like``'s structure holding ``leaves`` in flatten order."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(fill(x) for x in node)
        return None if node is None else next(it)
    return fill(like)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path: str, tree, meta: dict | None = None) -> None:
    """Atomically persist a nested structure of tensors or arrays, plus
    JSON-able metadata."""
    payload = {f"leaf_{i}": _to_numpy(l)
               for i, l in enumerate(tree_leaves(tree))}
    payload["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str, like):
    """Load a checkpoint into the structure of ``like``, a template of the
    same structure (e.g. a freshly initialised state).

    Returns (tree, meta). Each leaf comes back as a tensor on its template
    leaf's device (the CPU for a template leaf that is not a tensor). Leaf
    dtypes and shapes must match the template's; a mismatch raises
    ValueError naming the leaf.
    """
    template = tree_leaves(like)
    with np.load(path) as f:
        meta = json.loads(bytes(f["__meta__"]).decode()) \
            if "__meta__" in f.files else {}
        stored = [k for k in f.files if k.startswith("leaf_")]
        if len(stored) != len(template):
            raise ValueError(
                f"checkpoint {path} has {len(stored)} leaves, template has "
                f"{len(template)} -- structure changed since it was written")
        leaves = []
        for i, tmpl in enumerate(template):
            arr = f[f"leaf_{i}"]
            t = _to_numpy(tmpl)
            if arr.shape != t.shape or arr.dtype != t.dtype:
                raise ValueError(
                    f"leaf_{i}: checkpoint {arr.dtype}{arr.shape} vs "
                    f"template {t.dtype}{t.shape}")
            device = tmpl.device if isinstance(tmpl, torch.Tensor) else None
            leaves.append(torch.as_tensor(arr, device=device))
    return tree_unflatten(like, leaves), meta
