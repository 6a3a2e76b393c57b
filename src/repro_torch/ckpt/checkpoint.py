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
    (a checkpoint written from the card restores on the CPU and back);
  * elasticity -- a placed run writes whole leaves
    (:func:`save_with_placements`: rank 0 assembles each leaf on disk one
    block at a time), and :func:`restore_with_placements` reads each
    rank's block of them, leaf by leaf, under a mesh of any shape: the
    counterpart of the reference's ``restore_with_shardings``.  Neither
    holds more than one block of one leaf beyond the rank's own blocks;
  * retention -- keep_n garbage collection of old steps.

Leaves are torch tensors (any device) or numpy arrays when saving, and
CPU tensors when loading.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import threading
import zipfile
import zlib

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["flatten_paths", "process_count", "process_index",
           "save_checkpoint", "latest_step",
           "load_checkpoint", "restore_to_device", "save_with_placements",
           "restore_with_placements", "gc_checkpoints",
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


def _whole_shape(t, spec, ctx) -> tuple:
    from repro_torch.models.sharding import group_name
    return tuple(d * ({"model": ctx.n_model, "data": ctx.n_data}[
        group_name(ctx, ax)] if ax is not None else 1)
        for d, ax in zip(t.shape, tuple(spec) + (None,) * t.ndim))


def _block_index(whole, spec, ctx, data_rank, model_rank) -> tuple:
    """The slices of the block that the rank at (data_rank, model_rank)
    holds of a whole leaf of shape ``whole`` under ``spec``."""
    from repro_torch.models.sharding import group_name
    out = []
    for dim, size in enumerate(whole):
        ax = spec[dim] if dim < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        model = group_name(ctx, ax) == "model"
        r, n = (model_rank, ctx.n_model) if model else (data_rank,
                                                         ctx.n_data)
        out.append(slice(r * (size // n), (r + 1) * (size // n)))
    return tuple(out)


def _first_holder(spec, ctx, data_rank, model_rank) -> bool:
    """The rank holds its block first among the ranks that hold the same
    block (rank 0 of each group the placement does not split)."""
    from repro_torch.models.sharding import group_name
    used = {group_name(ctx, ax) for ax in spec if ax is not None}
    return ("model" in used or model_rank == 0) and \
        ("data" in used or data_rank == 0)


def _coords(ctx, device) -> list:
    """[(data rank, model rank)] of every rank of the world group, in
    its rank order."""
    mine = torch.tensor([ctx.data_rank, ctx.model_rank], dtype=torch.int64,
                        device=device)
    out = torch.empty((2 * ctx.size,), dtype=torch.int64, device=device)
    dist.all_gather_into_tensor(out, mine, group=ctx.world_group)
    return [tuple(c) for c in out.view(-1, 2).tolist()]


def _np_dtype(t: torch.Tensor):
    """(numpy dtype stored, true dtype string) of tensor ``t``'s leaf."""
    if t.dtype == torch.bfloat16:
        return np.dtype(np.uint16), "bfloat16"
    dt = torch.empty((0,), dtype=t.dtype).numpy().dtype
    return dt, str(dt)


_CHUNK = 1 << 26    # bytes a CRC pass reads at once


def _crc_chunked(arr) -> int:
    """CRC32 of ``arr``'s bytes in C order (:func:`_crc`), read in
    chunks (``arr`` may be a memory map larger than the host's memory)."""
    flat = arr.reshape(-1)
    step = max(_CHUNK // max(arr.itemsize, 1), 1)
    crc = 0
    for i in range(0, flat.size, step):
        crc = zlib.crc32(np.ascontiguousarray(flat[i:i + step]), crc)
    return crc


def save_with_placements(base: str, step: int, tree, placements: dict,
                         ctx, meta: dict | None = None):
    """Elastic save of a placed run (every rank calls it; collective):
    whole leaves in :func:`save_checkpoint`'s format and directory, each
    of the rank's blocks under ``placements`` ({flattened key:
    placement}).  Leaf by leaf, each block's first holder sends it to
    rank 0 (world group), which writes it into its place in a
    memory-mapped .npy on disk and then stores the file in arrays.npz: no
    rank holds more than its own blocks and one received block, on the
    card or the host.  Returns the directory on rank 0, else None."""
    me = dist.get_rank(ctx.world_group)
    flat = flatten_paths(tree)
    device = next(t.device for t in flat.values()
                  if isinstance(t, torch.Tensor))
    coords = _coords(ctx, device)
    final = _step_dir(base, step)
    tmp = f"{final}.tmp.{os.getpid()}"
    zf, leaves = None, {}
    if me == 0:
        os.makedirs(base, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        zf = zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w",
                             zipfile.ZIP_STORED, allowZip64=True)
    for key, t in flat.items():
        spec = tuple(placements.get(key, ()))
        if not any(ax is not None for ax in spec):
            if me == 0:
                arr, dtype = _storage(t)
                with zf.open(key + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                leaves[key] = {"shape": list(arr.shape), "dtype": dtype,
                               "crc32": _crc(arr)}
            continue
        whole = _whole_shape(t, spec, ctx)
        if me == 0:
            np_dtype, dtype = _np_dtype(t)
            npy = os.path.join(tmp, "leaf.npy")
            mm = np.lib.format.open_memmap(npy, mode="w+", dtype=np_dtype,
                                           shape=whole)
        for r, (dr, mr) in enumerate(coords):
            if not _first_holder(spec, ctx, dr, mr):
                continue
            if me == 0:
                blk = t
                if r != 0:
                    blk = torch.empty(t.shape, dtype=t.dtype, device=device)
                    dist.recv(blk, src=dist.get_global_rank(
                        ctx.world_group, r), group=ctx.world_group)
                mm[_block_index(whole, spec, ctx, dr, mr)] = _storage(blk)[0]
                del blk
            elif me == r:
                dist.send(t.contiguous(), dst=dist.get_global_rank(
                    ctx.world_group, 0), group=ctx.world_group)
        if me == 0:
            mm.flush()
            leaves[key] = {"shape": list(whole), "dtype": dtype,
                           "crc32": _crc_chunked(mm)}
            del mm
            zf.write(npy, arcname=key + ".npy")
            os.remove(npy)
    if me != 0:
        return None
    zf.close()
    manifest = {"step": step, "meta": meta or {},
                "process_count": process_count(), "leaves": leaves}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _npz_leaf(path: str, key: str):
    """Leaf ``key`` of the npz at ``path`` as a read-only memory map (an
    uncompressed member, as ``np.savez`` and :func:`save_checkpoint`
    write them), else read whole."""
    name = key + ".npy"
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo(name)
        if info.compress_type != zipfile.ZIP_STORED:
            with zf.open(name) as f:
                return np.lib.format.read_array(f, allow_pickle=False)
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)
        n_name, n_extra = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if math.prod(shape) == 0:
        return np.empty(shape, dtype)
    return np.memmap(path, dtype=dtype, mode="r", offset=offset,
                     shape=shape, order="F" if fortran else "C")


def restore_with_placements(base: str, template, placements: dict, ctx,
                            device, step: int | None = None):
    """Elastic restore: this rank's block of each whole leaf under
    ``placements`` ({flattened key: placement}) on ``ctx``'s mesh,
    whatever mesh wrote them, read leaf by leaf from a memory map of the
    checkpoint (each leaf's CRC verified in chunks), so the rank holds
    only its blocks; ``template``: the rank's tree (its blocks, whose
    dtypes the leaves take).  A whole shape that differs raises.  ->
    (step, tree of blocks on ``device``, meta)."""
    step = latest_step(base) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {base}")
    d = _step_dir(base, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    path = os.path.join(d, "arrays.npz")
    placed = {}
    for k, t in flatten_paths(template).items():
        info = manifest["leaves"][k]
        arr = _npz_leaf(path, k)
        if _crc_chunked(arr) != info["crc32"]:
            raise IOError(f"checkpoint corruption: CRC mismatch on {k}")
        spec = tuple(placements.get(k, ()))
        whole = _whole_shape(t, spec, ctx)
        if tuple(arr.shape) != whole:
            raise ValueError(f"checkpoint leaf {k}: shape {tuple(arr.shape)}"
                             f", expected {whole}")
        blk = np.array(arr[_block_index(whole, spec, ctx, ctx.data_rank,
                                        ctx.model_rank)])
        del arr
        placed[k] = _tensor(blk, info["dtype"]).to(device=device,
                                                   dtype=t.dtype, copy=True)
    return step, _unflatten_like(template, placed), manifest["meta"]


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
