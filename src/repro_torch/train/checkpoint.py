"""Fault-tolerant checkpointing without external dependencies.

A copy of ``repro.train.checkpoint`` in the same on-disk format, so a
checkpoint written by either package restores in the other:

* every leaf of a nested tree (dicts, lists, tuples; ``None`` is an empty
  subtree) is saved under a path key -- dict keys in sorted order, list
  and tuple indices, joined by ``/`` -- the names and the order
  ``jax.tree_util.tree_flatten_with_path`` gives the reference, without
  JAX;
* leaves are saved as numpy arrays (a tensor leaf is copied to the host
  in its own dtype; the broker hands over the reference's dtypes);
* writes are atomic (tmp dir + rename, manifest written last) -- a process
  killed mid-save never corrupts the previous checkpoint, and stale tmp
  dirs from such kills are swept by the next save's gc;
* the manifest records a per-array crc32, so a torn or tampered
  ``arrays.npz`` is *detected*: ``verify_step`` checks the sums,
  ``latest_verified_step`` walks backwards to the newest step that passes,
  and ``restore``/``load_leaf`` verify by default before handing arrays
  out;
* ``latest_step`` + ``restore`` implement restart-from-last-good-step, and
  ``keep`` bounds disk usage (ring of recent checkpoints).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(path key, leaf)`` pairs in the reference's order: dict keys
    sorted, sequences by index, depth first; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for name, sub in items:
        out.extend(_flatten_with_paths(sub, prefix + (name,)))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor, on any device
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _checksum(arr: np.ndarray) -> int:
    """crc32 of the array's raw bytes (contiguous, native order)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Atomically save a pytree checkpoint for ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = _flatten_with_paths(tree)
    arrays = {k: _to_host(v) for k, v in leaves}
    target = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "checksums": {k: _checksum(v) for k, v in arrays.items()},
        }
        # manifest last: its presence is the commit record of the step,
        # so a kill between the two writes leaves an ignorable tmp dir
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(target):
            shutil.rmtree(target)
        os.rename(tmp, target)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return target


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)
    # sweep tmp dirs abandoned by a kill mid-save (never picked up by
    # all_steps, but they'd accumulate on a crashy host)
    for name in os.listdir(ckpt_dir):
        if name.startswith(".tmp_"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.startswith(".tmp"):
            step_dir = os.path.join(ckpt_dir, name)
            # only complete checkpoints: the manifest is written last, and
            # both files must exist for the step to be loadable at all
            if os.path.exists(os.path.join(step_dir, "manifest.json")) and (
                os.path.exists(os.path.join(step_dir, "arrays.npz"))
            ):
                out.append(int(name[len("step_") :]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: int) -> Dict[str, Any]:
    with open(
        os.path.join(ckpt_dir, f"step_{step:010d}", "manifest.json")
    ) as f:
        return json.load(f)


def verify_step(ckpt_dir: str, step: int) -> bool:
    """True iff ``step``'s arrays match its manifest checksums.

    Any failure -- unreadable archive (torn write), missing key, shape or
    checksum mismatch (tampered bytes) -- verifies False.  Manifests
    predating checksums (no ``checksums`` field) verify True: they carry
    no sums to contradict.
    """
    target = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        manifest = read_manifest(ckpt_dir, step)
        sums = manifest.get("checksums")
        with np.load(os.path.join(target, "arrays.npz")) as data:
            for key in manifest["keys"]:
                arr = data[key]  # raises on missing / undecodable
                if list(arr.shape) != manifest["shapes"][key]:
                    return False
                if sums is not None and _checksum(arr) != int(sums[key]):
                    return False
    except Exception:
        return False
    return True


def latest_verified_step(ckpt_dir: str) -> Optional[int]:
    """The newest step whose arrays pass checksum verification -- the
    step recovery should restore from when the latest may be corrupt."""
    for step in reversed(all_steps(ckpt_dir)):
        if verify_step(ckpt_dir, step):
            return step
    return None


def load_leaf(
    ckpt_dir: str, step: int, key: str, verify: bool = True
) -> Optional[np.ndarray]:
    """Load one leaf by path key, or None if absent (optional metadata --
    e.g. the serialized CacheSpec a broker checkpoint was produced under).
    With ``verify`` (default), a checksum mismatch raises instead of
    returning corrupt bytes."""
    target = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(target, "arrays.npz")) as data:
        if key not in data.files:
            return None
        arr = data[key]
    if verify:
        sums = read_manifest(ckpt_dir, step).get("checksums")
        if sums is not None and key in sums and _checksum(arr) != int(sums[key]):
            raise ValueError(
                f"checksum mismatch for leaf {key!r} in step {step} of "
                f"{ckpt_dir} (corrupt checkpoint)"
            )
    return arr


def restore(
    ckpt_dir: str, tree_like, step: Optional[int] = None, verify: bool = True
):
    """Restore into the structure of ``tree_like`` (shapes validated).

    With ``verify`` (default), arrays are checked against the manifest
    checksums and a corrupt checkpoint raises ``ValueError`` -- callers
    wanting automatic fallback pick ``step=latest_verified_step(...)``.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    target = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(target, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    if verify:
        sums = read_manifest(ckpt_dir, step).get("checksums")
        if sums is not None:
            for k, arr in arrays.items():
                if k in sums and _checksum(arr) != int(sums[k]):
                    raise ValueError(
                        f"checksum mismatch for leaf {k!r} in step {step} "
                        f"of {ckpt_dir} (corrupt checkpoint)"
                    )
    leaves = _flatten_with_paths(tree_like)
    new_leaves = []
    for key, ref in leaves:
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != _shape(ref):
            raise ValueError(
                f"shape mismatch for {key!r}: ckpt {arr.shape} vs model {_shape(ref)}"
            )
        new_leaves.append(arr)
    return _unflatten(tree_like, iter(new_leaves)), step
