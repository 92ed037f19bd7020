"""Checkpointing: atomic, self-describing, restorable into a live tree; the
counterpart of ``repro/checkpoint/checkpoint.py``.

- **Atomicity**: a checkpoint is written to ``step_N.tmp/`` and renamed
  into place only after every array and the manifest are on disk, so a
  writer killed midway never spoils the newest checkpoint.
- **Self-describing**: the manifest records the step, the mesh shape and,
  for each leaf, its tree path (``['embed']['tok']``), file, shape and
  dtype.
- **Restore** reads each leaf onto the device and into the dtype of the
  live tree's leaf at the same path, after checking its shape.
- **Sharded and elastic**: with ``shardings=`` (a tree of each leaf's
  :class:`~repro_torch.dist.sharding.Sharding`, the trees holding a rank's
  slices), save gathers each leaf whole and rank 0 alone writes it, with
  the mesh's shape in the manifest; restore reads each whole leaf and keeps
  this rank's slice of the *live* mesh's placement, which may differ from
  the saver's (the layout on disk is the global one).
- **Retention**: the newest ``keep`` checkpoints stay; older ones are
  deleted only once a newer one is published.

Arrays are ``.npy`` files, one a leaf.  numpy has no bf16, so a bf16 leaf
is stored as its uint16 bits, its dtype in the manifest: the round trip
is bitwise.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.params import tree_flatten_as, tree_leaves, tree_paths, tree_unflatten

MANIFEST = "manifest.json"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _published(ckpt_dir: str) -> list[str]:
    return sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _writer(shardings: Any) -> bool:
    """Whether this process writes: rank 0 of a sharded save, or any
    process saving a whole tree."""
    return shardings is None or not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *, mesh_shape: tuple[int, ...] = (),
                    keep: int = 3, extra_meta: dict | None = None,
                    shardings: Any = None) -> str:
    """Write ``tree`` (dicts, lists and tuples of tensors) as
    ``ckpt_dir/step_{step:08d}``; returns its path.  With ``shardings``
    every rank calls it (each leaf is gathered whole), rank 0 writes, and
    all return once the checkpoint is published."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves = tree_leaves(tree)
    if shardings is not None:
        leaves = [sh.gather(x) for x, sh in zip(leaves, tree_flatten_as(tree, shardings))]
    if not _writer(shardings):
        dist.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    entries = []
    for i, (key, leaf) in enumerate(zip(tree_paths(tree), leaves)):
        fname = f"arr_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, _to_numpy(leaf))
            f.flush()
            os.fsync(f.fileno())
        entries.append({"key": key, "file": fname, "shape": list(leaf.shape),
                        "dtype": str(leaf.dtype).removeprefix("torch.")})
    manifest = {"step": step, "time": time.time(), "mesh_shape": list(mesh_shape),
                "entries": entries, **(extra_meta or {})}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish

    for old in _published(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, old), ignore_errors=True)
    if shardings is not None and dist.is_initialized():
        dist.barrier()
    return final


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The newest published checkpoint with a manifest, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    for cand in reversed(_published(ckpt_dir)):
        path = os.path.join(ckpt_dir, cand)
        if os.path.exists(os.path.join(path, MANIFEST)):
            return path
    return None


def restore_checkpoint(path: str, tree_like: Any, *, shardings: Any = None) -> tuple[Any, dict]:
    """(a tree of ``tree_like``'s structure holding the checkpoint's
    arrays, the manifest).  Each leaf goes to the device and dtype of
    ``tree_like``'s leaf at its path; a missing or extra leaf, or another
    shape, raises ``ValueError``.  With ``shardings`` (the live mesh's
    placements, ``tree_like`` this rank's slices) each leaf is this rank's
    slice of the stored whole one."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    likes, keys = tree_leaves(tree_like), tree_paths(tree_like)
    entries = manifest["entries"]
    if len(likes) != len(entries):
        raise ValueError(f"checkpoint has {len(entries)} leaves, model expects {len(likes)}")
    # looked up by path, so two trees whose dicts list a layer's leaves in
    # another order restore into each other
    by_key, live = {e["key"]: e for e in entries}, set(keys)
    unmatched = [e["key"] for e in entries if e["key"] not in live]
    shards = (tree_flatten_as(tree_like, shardings) if shardings is not None
              else [None] * len(likes))
    out = []
    for key, like, sh in zip(keys, likes, shards):
        entry = by_key.get(key)
        if entry is None:
            raise ValueError(f"checkpoint leaf {', '.join(unmatched) or '(none)'} where {key} "
                             "is expected")
        arr = np.load(os.path.join(path, entry["file"]))
        shape = tuple(arr.shape) if sh is None else sh.local_shape(arr.shape)
        if shape != tuple(like.shape):
            raise ValueError(f"{key}: shape {shape} != {tuple(like.shape)}")
        t = _from_numpy(arr, entry["dtype"])
        if sh is not None:
            t = sh.local(t).contiguous()
        out.append(t.to(device=like.device, dtype=like.dtype))
    return tree_unflatten(tree_like, out), manifest
