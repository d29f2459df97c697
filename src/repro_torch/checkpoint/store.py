"""Checksummed, atomic checkpointing with async writes, in the JAX
store's on-disk format.

The port of ``repro/checkpoint/store.py``.  Layout:  <dir>/step_<N>/
  manifest.proc<i>.json   {step, format, leaves: [{key, file, shape,
                           dtype, crc32}]}
  <leaf>.proc<i>.npy      each leaf's raw bytes as a flat uint8 array

Keys are the paths ``jax.tree_util.tree_flatten_with_path`` gives the
same tree (``[0]/embed/table``, ``[1]/m/layers/attn/wq/w``, ``[1]/step``:
``utils.pytree.flatten_with_path``), the dtype is the numpy name
(``bfloat16``, ``float32``, ``int32``) and the CRC32 is over the raw
bytes, so a checkpoint written by either package restores in the other.
bf16 is written as its 2-byte pattern and read back by name, without
``ml_dtypes``.  Writes go to ``step_<N>.tmp`` and are renamed only after
the manifest is fsync'd, so a half-written checkpoint is never visible;
restore verifies every leaf's CRC32.  The process index is the
``torch.distributed`` rank when it is initialised, else 0.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.utils.pytree import flatten_with_path, unflatten


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _flatten(tree):
    return [("/".join(path) or "leaf", leaf)
            for path, leaf in flatten_with_path(tree)]


def _leaf_file(key: str, process_index: int) -> str:
    safe = key.replace("/", "__")
    return f"{safe}.proc{process_index}.npy"


def _to_numpy(leaf):
    """(numpy array of the leaf's bytes in its shape, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_raw(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(shape).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape).copy())


def save(tree, directory, step: int, *, keep: int = 3) -> Path:
    """Synchronous checkpoint save; returns the final step directory."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    proc = _process_index()

    manifest = {"step": step, "format": 1, "leaves": []}
    for key, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        fname = _leaf_file(key, proc)
        raw = np.ascontiguousarray(arr)
        crc = zlib.crc32(raw.tobytes())
        np.save(tmp / fname, raw.view(np.uint8).reshape(-1))
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": dtype, "crc32": crc})
    mpath = tmp / f"manifest.proc{proc}.json"
    mpath.write_text(json.dumps(manifest, indent=1))
    with open(mpath) as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _prune(directory, keep)
    return final


def _prune(directory: Path, keep: int):
    steps = sorted(p for p in directory.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory) -> int | None:
    directory = Path(directory)
    steps = sorted(int(p.name.split("_")[1])
                   for p in directory.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def restore(tree_like, directory, step: int | None = None):
    """Restore into the structure of ``tree_like`` (a tree of tensors):
    each leaf takes its dtype and device.  -> (tree, step)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = directory / f"step_{step:08d}"
    proc = _process_index()
    manifest = json.loads((d / f"manifest.proc{proc}.json").read_text())
    by_key = {m["key"]: m for m in manifest["leaves"]}

    out = []
    for key, like in _flatten(tree_like):
        meta = by_key[key]
        raw = np.load(d / meta["file"])
        crc = zlib.crc32(raw.tobytes())
        if crc != meta["crc32"]:
            raise IOError(f"checkpoint corruption in {key}: crc mismatch")
        arr = _from_raw(raw, meta["dtype"], meta["shape"])
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != "
                             f"{tuple(like.shape)}")
        out.append(arr.to(device=like.device, dtype=like.dtype))
    return unflatten(tree_like, out), manifest["step"]


class AsyncCheckpointer:
    """Background-thread checkpoint writer (training never blocks on IO).

    ``save`` copies the tree to host memory synchronously (the port
    updates params and optimizer state in place, so the writer gets its
    own copy) and writes in a worker thread; ``wait`` joins outstanding
    writes (call before exit and before restoring)."""

    def __init__(self, directory, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, tree, step: int):
        host = unflatten(tree, [
            x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
            else np.array(x) for _, x in flatten_with_path(tree)])
        self.wait()

        def work():
            try:
                save(host, self.directory, step, keep=self.keep)
            except Exception as e:   # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
