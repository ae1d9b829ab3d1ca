"""Atomic checkpoints of trees of tensors (the port of
``repro/checkpoint/checkpoint.py``), in the reference's on-disk layout:

    <dir>/step_<N>/
        manifest.json        {step, n_leaves, paths, shapes, dtypes}
        leaf_<i>.npy         one file per leaf
        COMMITTED            written last -> crash-safe atomic commit

written into ``step_<N>.tmp`` and moved into place by ``os.replace``.

A tree is nested dicts, lists and tuples with tensors, numpy arrays or
numbers at the leaves; ``None`` and empty containers hold no leaf.  Leaves
are numbered in JAX's flattening order (dict keys sorted, sequences in
order) and their paths written as ``jax.tree_util.keystr`` writes them,
so a checkpoint of the same tree written by either package restores in
the other: the reference's training state ``{"params", "opt"}`` with
Adam's ``{"m", "v", "t"}`` is the port's.  Restored leaves land on the
example leaf's device and dtype.  An async save copies every device leaf
to the host in the caller's thread, then writes on a worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch


def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{path}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten(v, f"{path}[{i}]"))
        return out
    return [(path, tree)]


def _unflatten(example, leaves):
    """``example``'s structure with its leaves taken from the iterator
    ``leaves`` in ``_flatten``'s order."""
    if example is None:
        return None
    if isinstance(example, dict):
        filled = {k: _unflatten(example[k], leaves) for k in sorted(example)}
        return {k: filled[k] for k in example}
    if isinstance(example, (list, tuple)):
        return type(example)(_unflatten(v, leaves) for v in example)
    return next(leaves)


def _host(leaf, copy: bool) -> np.ndarray:
    """A leaf as a host numpy array; ``copy`` also copies a leaf that lies
    on the host already (an async writer must not see later writes)."""
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
        return arr.copy() if copy and not leaf.is_cuda else arr
    arr = np.asarray(leaf)
    return arr.copy() if copy else arr


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    async_: bool = False) -> threading.Thread | None:
    """Atomically save ``tree`` under step ``step``; with ``async_`` the
    files are written on a thread, which is returned (join it)."""
    flat = _flatten(tree)
    paths = [p for p, _ in flat]
    host_leaves = [_host(leaf, async_) for _, leaf in flat]

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "paths": paths,
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": [str(a.dtype) for a in host_leaves],
        }
        for i, a in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), a)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> int | None:
    """The highest committed step under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _restore_leaf(arr: np.ndarray, example, path: str):
    if isinstance(example, torch.Tensor):
        if tuple(arr.shape) != tuple(example.shape):
            raise ValueError(f"checkpoint leaf {path} has shape "
                             f"{list(arr.shape)}; expected "
                             f"{list(example.shape)}")
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=example.device, dtype=example.dtype)
    if isinstance(example, np.ndarray):
        return arr.astype(example.dtype, copy=False)
    return arr


def restore_checkpoint(ckpt_dir: str, example_tree: Any,
                       step: int | None = None) -> tuple[Any, int]:
    """Restore into the structure of ``example_tree`` -> (tree, step); the
    latest committed step unless ``step`` is given.  Raises ValueError
    when the checkpoint's leaves do not match the example's."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(example_tree)
    if len(flat) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves; "
                         f"expected {len(flat)}")
    paths = [p for p, _ in flat]
    if manifest.get("paths", paths) != paths:
        raise ValueError(f"checkpoint leaf paths {manifest['paths']} differ "
                         f"from the example's {paths}")
    leaves = [_restore_leaf(np.load(os.path.join(d, f"leaf_{i}.npy")), ex, p)
              for i, (p, ex) in enumerate(flat)]
    return _unflatten(example_tree, iter(leaves)), step
