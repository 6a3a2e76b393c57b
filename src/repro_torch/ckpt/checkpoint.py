"""Fault-tolerant checkpointing: atomic, async, integrity-checked -- the port
of ``repro/ckpt/checkpoint.py``, in the reference's format.

Format (one directory per step):
    step_000123/
      manifest.json   {step, meta, process_count, leaves: {key: shape,
                       dtype, crc32}}
      arrays.npz      flattened {key -> ndarray}

Keys are the reference's: a leaf's path through nested dicts (keys in
sorted order, as ``jax.tree_util`` visits them), lists and tuples
(indices), "/"-joined.  npz cannot hold bfloat16, so a bfloat16 leaf is
stored as its uint16 bits with dtype string "bfloat16", as the
reference stores it through ``ml_dtypes``; this module needs no such
extension.  Either package reads the other's checkpoints.

Guarantees:
  * atomicity -- written to step_XXX.tmp.<pid>, fsync'd, then os.replace'd;
    a crash mid-write never corrupts the latest valid checkpoint;
  * integrity -- CRC32 per leaf (of the stored bytes) verified on load;
  * async -- AsyncCheckpointer copies to host memory synchronously and
    serializes on a background thread, overlapping training;
  * relocation -- :func:`restore_to_device` places each leaf on a device
    (the torch counterpart of the reference's ``restore_with_shardings``:
    a checkpoint written from the card restores on the CPU and back);
  * retention -- keep_n garbage collection of old steps.

Leaves are torch tensors (any device) or numpy arrays when saving, and
CPU tensors when loading.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["flatten_paths", "process_count", "process_index",
           "save_checkpoint", "latest_step",
           "load_checkpoint", "restore_to_device", "gc_checkpoints",
           "AsyncCheckpointer"]


def flatten_paths(tree, prefix: str = "") -> dict:
    """{"/"-joined path: leaf} of a nested dict / list / tuple tree, in
    ``jax.tree.flatten`` order (dict keys sorted); None has no leaves."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten_like(template, leaves: dict, prefix: str = ""):
    """``template``'s structure with each leaf replaced by leaves[path]."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_like(v, leaves,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_like(v, leaves, f"{prefix}/{i}" if prefix else
                               str(i)) for i, v in enumerate(template)]
        return type(template)(out)
    return leaves[prefix]


def _storage(leaf):
    """(host numpy array to store, true dtype string) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def process_count() -> int:
    """Processes of the job: the default process group's world size when
    ``torch.distributed`` is initialised, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the default group, else 0."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _step_dir(base, step):
    return os.path.join(base, f"step_{step:08d}")


def save_checkpoint(base: str, step: int, tree, meta: dict | None = None):
    """Atomic synchronous save.  Returns the final directory path."""
    os.makedirs(base, exist_ok=True)
    final = _step_dir(base, step)
    tmp = f"{final}.tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays, dtypes = {}, {}
    for key, leaf in flatten_paths(tree).items():
        arrays[key], dtypes[key] = _storage(leaf)
    manifest = {
        "step": step,
        "meta": meta or {},
        "process_count": process_count(),
        "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k],
                       "crc32": _crc(v)} for k, v in arrays.items()},
    }
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(base: str) -> int | None:
    if not os.path.isdir(base):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(base)
             if d.startswith("step_") and "tmp" not in d]
    return max(steps) if steps else None


def _tensor(arr, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(np.dtype(dtype), copy=False))


def load_checkpoint(base: str, template, step: int | None = None):
    """-> (step, tree of CPU tensors shaped like ``template``, meta);
    verifies every CRC."""
    step = latest_step(base) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    leaves = {}
    for k, info in manifest["leaves"].items():
        if _crc(arrays[k]) != info["crc32"]:
            raise IOError(f"checkpoint corruption: CRC mismatch on {k}")
        leaves[k] = _tensor(arrays[k], info["dtype"])
    return step, _unflatten_like(template, leaves), manifest["meta"]


def restore_to_device(base: str, template, device, step: int | None = None):
    """Load, then place every leaf on ``device`` in its template leaf's
    dtype (the template's leaves are tensors of the expected shapes);
    a shape that differs raises.  -> (step, tree, meta)."""
    step, tree, meta = load_checkpoint(base, template, step)
    want = flatten_paths(template)
    placed = {}
    for k, t in flatten_paths(tree).items():
        if tuple(t.shape) != tuple(want[k].shape):
            raise ValueError(f"checkpoint leaf {k}: shape {tuple(t.shape)}, "
                             f"expected {tuple(want[k].shape)}")
        placed[k] = t.to(device=device, dtype=want[k].dtype)
    return step, _unflatten_like(template, placed), meta


def gc_checkpoints(base: str, keep_n: int):
    if not os.path.isdir(base):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(base)
                   if d.startswith("step_") and "tmp" not in d)
    for s in steps[:-keep_n] if keep_n else []:
        shutil.rmtree(_step_dir(base, s), ignore_errors=True)


def _snapshot(leaf):
    """A host copy that later in-place updates of ``leaf`` cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class AsyncCheckpointer:
    """Snapshot-then-write-async checkpointing with keep-N GC.

    save() blocks only for the device -> host copy; serialization and disk
    IO run on a worker thread.  wait() joins outstanding writes (call
    before exit and before restoring) and raises a write's error."""

    def __init__(self, base: str, keep_n: int = 3):
        self.base = base
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, meta=None):
        self.wait()
        host = flatten_paths(tree)
        host_tree = _unflatten_like(tree, {k: _snapshot(v)
                                           for k, v in host.items()})

        def work():
            try:
                save_checkpoint(self.base, step, host_tree, meta)
                gc_checkpoints(self.base, self.keep_n)
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
