"""Checkpointing: async atomic save, restore, retention.

Port of ``repro/checkpoint/ckpt.py``, in its on-disk format, so that
either package reads the other's float32 checkpoints: one ``.npy`` file a
leaf, named by its tree path joined with ``__`` (``opt__master__embed__
tokens``), plus a ``meta.json`` with the step and each leaf's name, shape
and dtype, written into a temp directory that is then renamed (a crash
mid-save never corrupts the latest checkpoint).

bfloat16 leaves.  The reference writes one as numpy's 2-byte raw type
(``|V2``) with ``"dtype": "bfloat16"`` in ``meta.json``; so does the port.
The reference hands such a leaf back as a raw array, which JAX refuses;
the port reads it back by ``meta.json``'s dtype, as 16-bit integers viewed
as ``torch.bfloat16`` (numpy has no bfloat16 without ``ml_dtypes``).

``AsyncCheckpointer.save`` copies the tree to host memory, then writes on
a background thread, so the train loop overlaps checkpoint I/O with
compute.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.layers import flatten_tree, unflatten_tree

#: The header type of the reference's bfloat16 leaves: ``ml_dtypes``'s
#: bfloat16 describes itself to ``np.save`` as 2-byte raw, little-endian.
_BF16_DESCR = "<V2"


def _items(tree):
    """(file name, leaf) in the reference's order (keys sorted)."""
    leaf = lambda x: not isinstance(x, dict)
    return [(path.replace("/", "__"), x) for path, x in
            sorted(flatten_tree(tree, leaf), key=lambda item: item[0])]


def _save_leaf(path: str, leaf) -> dict:
    """Write one leaf's ``.npy``; returns its ``meta.json`` entry's shape
    and dtype.  A bfloat16 tensor goes out as the reference writes one:
    the ``.npy`` header of its raw 2-byte type, then the bits."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            bits = leaf.contiguous().view(torch.int16).numpy()
            with open(path, "wb") as f:
                np.lib.format.write_array_header_1_0(f, {
                    "descr": _BF16_DESCR, "fortran_order": False,
                    "shape": bits.shape})
                f.write(bits.tobytes())
            return {"shape": list(bits.shape), "dtype": "bfloat16"}
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    np.save(path, arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def save(tree, directory: str, step: int):
    """Synchronous atomic checkpoint write of a tree of tensors or arrays."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-step-{step}")
    final = os.path.join(directory, f"step-{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    meta = {"step": step, "leaves": []}
    for name, leaf in _items(tree):
        meta["leaves"].append({"name": name, **_save_leaf(
            os.path.join(tmp, name + ".npy"), leaf)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(directory)
             if d.startswith("step-")]
    return max(steps) if steps else None


def restore(tree_like, directory: str, step: int | None = None,
            device="cuda"):
    """Load a checkpoint into the structure of ``tree_like`` (any tree of
    the same paths: tensors, meta tensors from ``train_state_specs``, or
    arrays) as tensors on ``device``.  Returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step-{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        dtypes = {leaf["name"]: leaf["dtype"]
                  for leaf in json.load(f)["leaves"]}
    paths = [path for path, _ in flatten_tree(
        tree_like, lambda x: not isinstance(x, dict))]
    out = []
    for path in paths:
        name = path.replace("/", "__")
        arr = np.load(os.path.join(d, name + ".npy"))
        if dtypes[name] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append((path, t.to(device)))
    return unflatten_tree(out), step


def retain(directory: str, keep: int = 3):
    """Delete all but the newest ``keep`` checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("-")[1]) for d in os.listdir(directory)
                   if d.startswith("step-"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step-{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Overlap checkpoint writes with training compute."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: concurrent.futures.Future | None = None

    def save(self, tree, step: int):
        # Snapshot to host synchronously, write asynchronously.
        host_tree = unflatten_tree(
            (path, leaf.detach().to("cpu", copy=True) if torch.is_tensor(leaf)
             else np.array(leaf))
            for path, leaf in flatten_tree(
                tree, lambda x: not isinstance(x, dict)))
        self.wait()

        def _write():
            path = save(host_tree, self.directory, step)
            retain(self.directory, self.keep)
            return path

        self._pending = self._pool.submit(_write)
        return self._pending

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self):
        self.wait()
        self._pool.shutdown()
