"""Checkpoint store: the twin of ``repro.checkpoint.store`` — the same
directory protocol, manifest and checksums, so a checkpoint written by
either package restores in the other:

  <dir>/step_000123.tmp/      written first
      arrays.npz              flat {path -> ndarray}
      manifest.json           {"step", "checksums", "dtypes", "meta"}
  <dir>/step_000123/          atomic rename when complete

Leaves are flattened to the JAX package's paths: a NamedTuple's fields,
a dict's keys and a model's parameter names (dots become "/"), joined by
"/" (``TrainState`` gives ``params/stage1/attn/wq``,
``opt/master/...``, ``opt/step``).  bf16 leaves are stored as their
uint16 view with ``"bfloat16"`` in ``dtypes``, as the JAX store does.
``restore`` checks every array (checksum, shape) before it writes any,
then copies them into the tensors of `like` IN PLACE and returns a tree
of `like`'s structure holding them (a leaf of `like` that is not a
tensor comes back as a new CPU tensor).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

SEP = "/"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed checksum validation on restore."""


def _key(k: Any) -> str:
    return str(k).replace(".", SEP)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    if tree is None:
        return flat
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, nn.Module):
        items = list(tree.named_parameters())
    else:
        flat[prefix[:-1]] = tree
        return flat
    for k, sub in items:
        flat.update(_flatten(sub, prefix + _key(k) + SEP))
    return flat


def _to_numpy(v: Any) -> Tuple[np.ndarray, str]:
    """(the array as stored, its dtype name)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(v)
    return a, str(a.dtype)


def _checksum(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a).view(np.uint8)).hexdigest()[:16]


def save(dirpath: str, step: int, tree: Any,
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Write one atomic checkpoint; returns the final path.  Overwriting
    an existing step swaps via a `.old` rename, so a complete copy of
    the data exists on disk at every instant (see ``recover``)."""
    os.makedirs(dirpath, exist_ok=True)
    recover(dirpath)
    final = os.path.join(dirpath, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays, checksums, dtypes = {}, {}, {}
    for k, v in _flatten(tree).items():
        a, dtypes[k] = _to_numpy(v)
        arrays[k] = a
        checksums[k] = _checksum(a)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "checksums": checksums, "dtypes": dtypes,
                "meta": meta or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        old = final + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(final, old)       # previous checkpoint stays complete...
        os.rename(tmp, final)       # ...until the new one is in place
        shutil.rmtree(old)
    else:
        os.rename(tmp, final)
    return final


def recover(dirpath: str) -> List[str]:
    """Repair save() sequences interrupted between the two renames: for
    each orphaned `step_X.old` whose `step_X` is missing, promote the
    completed tmp (newer data) if it verifies, else the `.old`.  Returns
    the paths repaired.  A `.old` next to a complete `step_X` is
    dropped."""
    if not os.path.isdir(dirpath):
        return []
    repaired: List[str] = []
    for name in sorted(os.listdir(dirpath)):
        m = re.fullmatch(r"(step_\d+)\.old", name)
        if not m:
            continue
        final = os.path.join(dirpath, m.group(1))
        old = os.path.join(dirpath, name)
        tmp = final + ".tmp"
        if os.path.exists(final):
            if _is_complete(final):
                shutil.rmtree(old, ignore_errors=True)
            continue
        if verify(tmp):
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
            repaired.append(final)
        elif verify(old):
            os.rename(old, final)
            repaired.append(final)
    return repaired


def _is_complete(path: str) -> bool:
    return (os.path.isdir(path)
            and os.path.exists(os.path.join(path, "manifest.json"))
            and os.path.exists(os.path.join(path, "arrays.npz")))


def list_steps(dirpath: str) -> List[int]:
    if not os.path.isdir(dirpath):
        return []
    steps = []
    for name in os.listdir(dirpath):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and _is_complete(os.path.join(dirpath, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def verify(path: str) -> bool:
    """Checksum validation — detects torn/corrupt checkpoints."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            for k, want in manifest["checksums"].items():
                if _checksum(z[k]) != want:
                    return False
        return True
    except Exception:
        return False


def _shape(v: Any) -> Tuple[int, ...]:
    return tuple(v.shape) if hasattr(v, "shape") else ()


def _fill(like: Any, arrays: Dict[str, np.ndarray], dtypes: Dict[str, str],
          prefix: str = "") -> Any:
    """`like`'s structure holding the restored leaves (tensors written in
    place)."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_fill(getattr(like, f), arrays, dtypes,
                                  prefix + f + SEP) for f in like._fields])
    if isinstance(like, dict):
        return {k: _fill(v, arrays, dtypes, prefix + _key(k) + SEP)
                for k, v in like.items()}
    if isinstance(like, nn.Module):
        for name, p in like.named_parameters():
            _fill(p, arrays, dtypes, prefix + _key(name) + SEP)
        return like
    key = prefix[:-1]
    a = arrays[key]
    if dtypes[key] == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if isinstance(like, torch.Tensor):
        with torch.no_grad():
            like.copy_(t.to(like.dtype))
        return like
    return t


def restore(dirpath: str, step: int, like: Any, *,
            strict: bool = True) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of `like`.  With `strict=True` every
    array is checksummed against the manifest first and a mismatch
    raises `CheckpointCorrupt`; shapes must match.  Nothing is written
    into `like` unless every leaf passes."""
    path = os.path.join(dirpath, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for k, proto in _flatten(like).items():
            a = z[k]
            if strict:
                want = manifest["checksums"].get(k)
                # checksum the stored encoding, before any dtype view
                if want is None or _checksum(a) != want:
                    raise CheckpointCorrupt(
                        f"{path}: checksum mismatch for '{k}'")
            if tuple(a.shape) != _shape(proto):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{a.shape} vs {_shape(proto)}")
            arrays[k] = a
    return _fill(like, arrays, manifest["dtypes"]), manifest["meta"]


def restore_latest_verified(dirpath: str, like: Any
                            ) -> Tuple[int, Any, Dict[str, Any]]:
    """Walk `list_steps` newest-first and return the first checkpoint
    that restores cleanly (strict checksums), as (step, tree, meta).
    Raises `FileNotFoundError` if no checkpoint verifies."""
    recover(dirpath)
    for step in reversed(list_steps(dirpath)):
        try:
            tree, meta = restore(dirpath, step, like, strict=True)
            return step, tree, meta
        except Exception:
            # torn zip, checksum mismatch, truncated manifest, ... —
            # any load failure means "keep walking back"
            continue
    raise FileNotFoundError(f"no verifiable checkpoint under {dirpath}")
