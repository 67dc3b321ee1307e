"""Fault-tolerant checkpointing: atomic, manifest-based, device-independent,
as ``repro.checkpoint``.

Layout:   <dir>/step_000123/
            manifest.json        — step, tree structure, leaf shapes/dtypes/CRCs
            arr_00000.npy ...    — one file per leaf (host numpy)
          <dir>/LATEST           — atomic pointer (rename-into-place)

* Atomic commit: every file is written into a temporary directory, the
  manifest fsync'd, then the directory renamed; the LATEST pointer is
  updated last, so a crash mid-save never corrupts the restore path.
* Device independence: tensors are saved as host arrays and restored onto
  the devices of the ``tree_like`` given to :func:`restore_checkpoint`.
* bfloat16 tensors are saved as their ``uint16`` bits (``Tensor.view``) with
  the true dtype in the manifest, and viewed back on restore: bit-stable,
  and the same files the JAX package writes.
* Garbage collection keeps the newest ``keep`` checkpoints.
* Integrity: the manifest records a CRC32 per leaf; :func:`verify_checkpoint`
  re-hashes the files, and :func:`latest_step` and
  :func:`restore_checkpoint` (``step=None``) skip entries that fail, so a
  corrupt or truncated newest checkpoint degrades to the newest verifiable
  one instead of a crash or a silent restore of bad bytes.

Trees are the port's state trees (:mod:`repro_torch.tree_util`): tensors,
numpy arrays and Python numbers as leaves.

A state sharded over a mesh is written and read one leaf at a time: the
writer takes its leaves from an iterator (``leaves=``, e.g.
``parallel.iter_gathered_leaves``, which gathers each when it is reached)
and the reader cuts each full leaf to the rank's part on the host
(``layout=``, a ``parallel.sharding.StateLayout``), so neither holds more
than one full leaf. The files are those a one-rank run writes.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree_util
from repro_torch.resilience import faults

MANIFEST = "manifest.json"
LATEST = "LATEST"


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(savable array, true dtype name) of a leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    a = np.asarray(x)
    return a, str(a.dtype)


def _from_saved(arr: np.ndarray, dtype_name: str, like, cut=None) -> Any:
    """A loaded array as the type of ``like``: a tensor on its device (cut
    to a rank's part on the host first, by ``cut``), a Python number, or a
    numpy array."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.require(arr, requirements="CW"))   # keeps a 0-d shape
        if dtype_name == "bfloat16":
            t = t.view(torch.bfloat16)
        return (t if cut is None else cut(t)).to(like.device)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    return arr


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3,
                    prefix: str = "step_", update_latest: bool = True,
                    leaves=None) -> str:
    """Atomically write ``tree`` as checkpoint ``step``. Returns the path.

    A non-default ``prefix`` (with ``update_latest=False``) writes a side
    artifact that auto-resume and GC never look at: the generator-refresh
    snapshots (``gensnap_<step>``) use it so an in-flight fit can be
    replayed after a restart without moving the LATEST pointer.

    ``leaves``: an iterable of the leaves to write in ``tree``'s flatten
    order (``tree`` then gives only the structure), each written and
    dropped as it comes (module docstring).
    """
    os.makedirs(directory, exist_ok=True)
    flat, spec = tree_util.flatten(tree)
    n = len(flat)
    leaves = flat if leaves is None else leaves
    final = os.path.join(directory, f"{prefix}{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        meta = {"step": step, "treedef": tree_util.spec_str(spec),
                "n_leaves": n, "leaves": []}
        for i, leaf in enumerate(leaves):
            arr, dtype_name = _to_host(leaf)
            del leaf
            meta["leaves"].append({"shape": list(arr.shape), "dtype": dtype_name,
                                   "crc32": int(zlib.crc32(np.ascontiguousarray(arr)))})
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr)
            del arr
        if len(meta["leaves"]) != n:
            raise ValueError(f"{len(meta['leaves'])} leaves written, the tree has {n}")
        # Site "checkpoint/write": arrays are on disk but the manifest — the
        # commit record — is not. A kill held here leaves an unverifiable
        # tmp dir that restore must ignore.
        faults.fire("checkpoint/write")
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        # Site "checkpoint/commit": the last instant at which a kill loses
        # this checkpoint entirely (tmp never renamed).
        faults.fire("checkpoint/commit")
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if update_latest:
        ptr_tmp = os.path.join(directory, ".LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.rename(ptr_tmp, os.path.join(directory, LATEST))
    if keep > 0:
        _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def verify_checkpoint(path: str) -> bool:
    """True iff ``path`` is a complete, uncorrupted checkpoint directory: the
    manifest parses, every leaf file exists with the recorded shape, and
    every CRC32 recorded matches. Never raises on damage; damage is the
    expected input."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            meta = json.load(f)
        leaves = meta["leaves"]
        if meta["n_leaves"] != len(leaves):
            return False
        for i, info in enumerate(leaves):
            arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
            if list(arr.shape) != list(info["shape"]):
                return False
            crc = info.get("crc32")
            if crc is not None and zlib.crc32(np.ascontiguousarray(arr)) != crc:
                return False
        return True
    except Exception:
        return False


def _step_dirs(directory: str, prefix: str = "step_") -> List[int]:
    """Every checkpoint step on disk (complete or not), newest first."""
    steps = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.startswith(prefix):
                try:
                    steps.append(int(name[len(prefix):]))
                except ValueError:
                    continue
    return sorted(steps, reverse=True)


def latest_step(directory: str, verify: bool = True) -> Optional[int]:
    """Newest restorable step. Prefers the LATEST pointer; if its target is
    missing or unverifiable (or the pointer itself is gone), falls back to
    the newest ``step_*`` directory that verifies."""
    candidates: List[int] = []
    ptr = os.path.join(directory, LATEST)
    if os.path.exists(ptr):
        with open(ptr) as f:
            name = f.read().strip()
        try:
            candidates.append(int(name.split("_")[1]))
        except (IndexError, ValueError):
            pass
    for s in _step_dirs(directory):
        if s not in candidates:
            candidates.append(s)
    for s in candidates:
        path = os.path.join(directory, f"step_{s:08d}")
        if not os.path.exists(os.path.join(path, MANIFEST)):
            continue
        if not verify or verify_checkpoint(path):
            return s
    return None


def restore_checkpoint(directory: str, tree_like: Any, step: Optional[int] = None,
                       prefix: str = "step_", layout=None) -> Tuple[Any, int]:
    """Restore into the structure of ``tree_like``: each tensor leaf comes
    back as a tensor on that leaf's device, each Python number as a number.

    With ``step=None`` the restore point is the newest verifiable
    checkpoint; an explicit ``step`` that fails verification raises rather
    than returning bad bytes.

    ``layout`` (a ``parallel.sharding.StateLayout`` of ``tree_like``, a
    rank's state): the files hold the full leaves, each checked against
    the full shape and cut to the rank's part on the host (module
    docstring)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"{prefix}{step:08d}")
    if not verify_checkpoint(path):
        raise IOError(f"checkpoint {path} failed integrity verification")
    with open(os.path.join(path, MANIFEST)) as f:
        meta = json.load(f)
    leaves_like, spec = tree_util.flatten(tree_like)
    if meta["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, expected "
                         f"{len(leaves_like)}")
    out = []
    for i, (info, like) in enumerate(zip(meta["leaves"], leaves_like)):
        arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
        want = tuple(np.shape(like)) if layout is None else layout.full_shape(i, like)
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint shape {arr.shape}, expected {want}")
        cut = None if layout is None else (lambda t, i=i: layout.cut(i, t))
        out.append(_from_saved(arr, info["dtype"], like, cut))
        del arr
    return tree_util.unflatten(spec, out), step
