"""Atomic checkpoints in the reference's on-disk format (counterpart of
``repro.ckpt.checkpoint``).

Layout (one directory per step)::

    ckpt_dir/step_00000042/
        manifest.json        # leaf name -> file, key, shape, dtype, crc32
        shard_00000.npz      # one file per host (one here)
    ckpt_dir/LATEST          # atomic pointer file

The format is the reference's, so a checkpoint of either package restores
in the other: leaf names join dict keys in sorted order (as ``jax.tree``
flattens) and list indices with ``/``; bf16 is stored as its ``uint16``
bits with the logical dtype ``"bfloat16"``; each leaf carries the crc32 of
its stored bytes, verified on restore.

* **Atomicity**: writes go to ``step_k.tmp.<nonce>`` and are renamed into
  place after the shard and manifest are written; ``LATEST`` flips last.
* **Async save**: ``CheckpointManager.save(..., blocking=False)`` copies
  every leaf to host memory before it returns, then writes on a
  background thread.  The train step updates params and moments in place,
  so a thread that read the device tensors later would save a torn state.
* **Restore** takes a target tree of tensors (``meta`` or real: only the
  structure and dtypes are read), casts each leaf to the target's dtype and
  places it on ``device`` (``None``: the card).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "/"


def _flatten_with_paths(tree, prefix: tuple = ()) -> list:
    """[(name, leaf)] in ``jax.tree`` order: dict keys sorted, list and
    tuple entries by index."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_paths(v, prefix + (str(i),))]
    return [(_SEP.join(prefix), tree)]


def _unflatten_like(tree, values: dict, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values[_SEP.join(prefix)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A tensor's stored array (bf16 as its uint16 bits) and its logical
    dtype name; always a copy, so later in-place updates do not reach it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf)
    return a, str(a.dtype)


def _host_snapshot(state) -> list:
    return [(name, *_to_host(leaf))
            for name, leaf in _flatten_with_paths(state)]


def _write(ckpt_dir: str, step: int, snapshot: list, host_id: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp.", dir=ckpt_dir)
    try:
        arrays = {}
        manifest = {"step": step, "leaves": {}, "format": 1}
        for name, arr, logical_dtype in snapshot:
            key = f"a{len(arrays)}"
            arrays[key] = arr
            manifest["leaves"][name] = {
                "file": f"shard_{host_id:05d}.npz",
                "key": key,
                "shape": list(arr.shape),
                "dtype": logical_dtype,
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes())
                & 0xFFFFFFFF,
            }
        np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # flip the LATEST pointer atomically
        ptr_tmp = os.path.join(ckpt_dir, f".LATEST.tmp.{os.getpid()}")
        with open(ptr_tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(ckpt_dir: str, step: int, state, *,
                    host_id: int = 0) -> str:
    """Blocking save. Returns the final checkpoint path."""
    return _write(ckpt_dir, step, _host_snapshot(state), host_id)


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[-1])


def _from_stored(arr: np.ndarray, logical_dtype: str) -> torch.Tensor:
    if logical_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=logical_dtype))


def restore_checkpoint(ckpt_dir: str, target, step: Optional[int] = None, *,
                       device: str | torch.device | None = None,
                       verify: bool = True):
    """Restore into the structure of ``target`` (tensors, ``meta`` or real),
    each leaf cast to its target's dtype and placed on ``device``
    (``None``: the card).  Unknown manifest leaves are ignored; missing ones
    raise."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    cache: dict[str, Any] = {}

    def load(name: str) -> np.ndarray:
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint {path} missing leaf {name!r}")
        if meta["file"] not in cache:
            cache[meta["file"]] = np.load(os.path.join(path, meta["file"]))
        arr = cache[meta["file"]][meta["key"]]
        if verify:
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF
            if crc != meta["crc32"]:
                raise IOError(f"crc mismatch for {name} in {path}")
        return arr

    out = {}
    for name, tgt in _flatten_with_paths(target):
        val = _from_stored(load(name), manifest["leaves"][name]["dtype"])
        out[name] = val.to(device=dev, dtype=tgt.dtype)
    return _unflatten_like(target, out)


@dataclasses.dataclass
class CheckpointManager:
    """Async save + retention + resume helper."""

    ckpt_dir: str
    keep: int = 3
    _thread: Optional[threading.Thread] = None
    _error: Optional[BaseException] = None

    def save(self, step: int, state, *, blocking: bool = False) -> None:
        self.wait()
        snapshot = _host_snapshot(state)  # before returning: see above

        def work():
            try:
                _write(self.ckpt_dir, step, snapshot, 0)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            self.raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, target, *,
                       device: str | torch.device | None = None):
        self.wait()
        return restore_checkpoint(self.ckpt_dir, target, device=device)

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[-1])
            for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and ".tmp." not in d
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
