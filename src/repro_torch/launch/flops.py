"""Analytic FLOP and HBM-byte counting by tracing -- the port of
``repro/launch/flops.py``.

The reference walks the jaxpr, where loop trip counts must be applied by
hand; eager PyTorch makes every loop explicit, so a
``TorchDispatchMode`` over the forward and the backward sees every
executed op once per execution -- remat recompute included (a
checkpointed region runs its forward again inside the backward).  It
counts, with the reference's formulas:

  * matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``; an
    einsum or ``x @ w`` lowers to these): 2 * batch * M * N * K;
  * FFT (``_fft_c2c`` / ``_fft_r2c`` / ``_fft_c2r``): 5 * n_in * log2(n)
    per transformed axis, n_in the input's element count and n the
    axis's transform length (the output length for ``c2r``, as the
    reference's ``fft_lengths``);
  * convolution: 2 * output elements * kernel elements / output channels
    (the reference's ``conv_general_dilated`` formula);

elementwise ops are bandwidth, not FLOPs, and are not counted.  Bytes:
each counted op's operands and result, once (elementwise chains are
taken as fused into them, as the reference assumes for the TPU).
``torch.utils.flop_counter.FlopCounterMode`` counts no FFT, so the
formulas are kept here.

Works on meta tensors (nothing is allocated, nothing runs).  Ops inside
the ``sharded`` modules -- their forward, and the backward of every
autograd node their forward created (tagged through a
``TorchFunctionMode``) -- are tallied apart, so that a caller can scale
them by the mesh size like the reference's ``shard_map`` bodies; so are
the ops a placed model runs under
:func:`repro_torch.models.sharding.split_work` (a rank's block of a
model-split dimension), which the caller scales by the model axis.
A stand-in for a kernel that cannot run on meta tensors adds its own
count with :meth:`Counter.note`.
"""
from __future__ import annotations

import math

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.models.sharding import in_split_work

__all__ = ["Counter", "analytic_flops", "analytic_bytes", "active"]

aten = torch.ops.aten
_ACTIVE: list = []


def active():
    """The innermost :class:`Counter` in use, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _mm(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b) -> int:
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _fft(x, lengths) -> int:
    return sum(int(5 * x.numel() * math.log2(n)) for n in lengths if n > 1)


def _op_flops(func, args, out) -> int | None:
    """FLOPs of one aten op, or None for an op that is not counted."""
    if func in (aten.mm.default, aten.mm.out):
        return _mm(args[0], args[1])
    if func is aten.addmm.default:
        return _mm(args[1], args[2])
    if func in (aten.bmm.default, aten.bmm.out):
        return _bmm(args[0], args[1])
    if func is aten.baddbmm.default:
        return _bmm(args[1], args[2])
    if func is aten.mv.default:
        return 2 * args[0].shape[0] * args[0].shape[1]
    if func is aten.dot.default:
        return 2 * args[0].shape[0]
    if func is aten._fft_c2c.default or func is aten._fft_r2c.default:
        x, dims = args[0], args[1]
        return _fft(x, [x.shape[d] for d in dims])
    if func is aten._fft_c2r.default:
        x, dims, last = args[0], args[1], args[3]
        lengths = [x.shape[d] for d in dims[:-1]] + [last]
        return _fft(x, lengths)
    if func in (aten.convolution.default, aten._convolution.default):
        w = args[1]
        return 2 * out.numel() * w.numel() // max(w.shape[0], 1)
    return None


def _grad_fns(tree):
    return [t.grad_fn for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.grad_fn is not None]


class _Tagger(TorchFunctionMode):
    """Marks the autograd nodes created inside a sharded module: every
    node between a call's outputs and its inputs (a call such as a 3-D
    ``x @ w`` creates several: view, mm, view)."""

    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tag = "repro_sharded" if self.counter._depth else \
            "repro_split" if in_split_work() else None
        if tag is not None:
            stop = set(_grad_fns((args, kwargs)))
            todo, seen = _grad_fns(out), set()
            while todo:
                node = todo.pop()
                if node is None or node in stop or node in seen:
                    continue
                seen.add(node)
                node.metadata[tag] = True
                todo.extend(n for n, _ in node.next_functions)
        return out


class Counter(TorchDispatchMode):
    """Counts FLOPs and bytes of every op run while it is entered.

    ``flops`` / ``bytes``: everything executed; ``sharded_flops`` /
    ``sharded_bytes``: the part inside ``sharded`` modules;
    ``split_flops`` / ``split_bytes``: the part under
    :func:`~repro_torch.models.sharding.split_work`.  ``logical_extra`` /
    ``split_logical_extra``: FLOPs a stand-in adds to the logical count
    beyond what it executes (:meth:`note`), outside and inside split
    work.  ``split`` switches the tagging on for a model with no
    ``sharded`` module (it costs a Python call an op)."""

    def __init__(self, sharded=(), split=False):
        super().__init__()
        self.flops = self.bytes = 0
        self.sharded_flops = self.sharded_bytes = 0
        self.split_flops = self.split_bytes = 0
        self.logical_extra = self.split_logical_extra = 0
        self._tag = bool(sharded) or split
        self.by_op: dict = {}
        self._depth = 0
        self._wrapped = []
        self._sharded = list(sharded)
        self._tagger = _Tagger(self)

    def _region(self) -> str | None:
        """"moe", "split" or None for the op being counted."""
        if self._depth:
            return "moe"
        if in_split_work():
            return "split"
        if torch.is_grad_enabled():
            # a forward op -- also a checkpoint's recompute, which runs
            # inside the backward of whatever node unpacked its tensors
            return None
        node = torch._C._current_autograd_node()
        if node is None:
            return None
        if node.metadata.get("repro_sharded", False):
            return "moe"
        return "split" if node.metadata.get("repro_split", False) else None

    def _add(self, name, flops, nbytes, logical=None):
        region = self._region()
        self.flops += flops
        self.bytes += nbytes
        if region == "moe":
            self.sharded_flops += flops
            self.sharded_bytes += nbytes
        elif region == "split":
            self.split_flops += flops
            self.split_bytes += nbytes
        if logical is not None:
            if region == "split":
                self.split_logical_extra += logical - flops
            else:
                self.logical_extra += logical - flops
        self.by_op[name] = self.by_op.get(name, 0) + flops

    def note(self, name: str, flops: int, nbytes: int,
             logical: int | None = None) -> None:
        """A stand-in's own count: ``flops`` executed, ``logical`` the
        reference's count of the same function (default: flops)."""
        self._add(name, int(flops), int(nbytes),
                  None if logical is None else int(logical))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f = _op_flops(func, args, out)
        if f is not None:
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            outs = [o for o in tree_flatten(out)[0]
                    if isinstance(o, torch.Tensor)]
            self._add(str(func.overloadpacket.__name__), f,
                      sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        return out

    def _wrap(self, forward):
        # try / finally, not forward hooks: a checkpoint's recompute stops
        # early by raising out of the module, past any post-hook
        def counted(*args, **kwargs):
            self._depth += 1
            try:
                return forward(*args, **kwargs)
            finally:
                self._depth -= 1
        return counted

    def __enter__(self):
        for m in self._sharded:
            m.forward = self._wrap(m.forward)
            self._wrapped.append(m)
        if self._tag:           # the tagger costs a Python call an op
            self._tagger.__enter__()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        _ACTIVE.pop()
        if self._tag:
            self._tagger.__exit__(*exc)
        for m in self._wrapped:
            del m.forward
        self._wrapped.clear()
        return out

    def global_flops(self, mesh_size: int = 1, data_size: int = 1,
                     n_model: int = 1) -> int:
        """The reference's global count: the rank's replicated work times
        ``data_size`` (the ranks that split the batch), its split work
        times ``data_size * n_model``, its sharded modules' work times
        ``mesh_size``, with the stand-ins' logical extra."""
        plain = self.flops - self.sharded_flops - self.split_flops \
            + self.logical_extra
        split = self.split_flops + self.split_logical_extra
        return data_size * (plain + n_model * split) \
            + mesh_size * self.sharded_flops

    def global_bytes(self, mesh_size: int = 1, data_size: int = 1,
                     n_model: int = 1) -> int:
        plain = self.bytes - self.sharded_bytes - self.split_bytes
        return data_size * (plain + n_model * self.split_bytes) \
            + mesh_size * self.sharded_bytes


def analytic_flops(fn, *args, mesh_size: int = 1, data_size: int = 1,
                   sharded=()) -> int:
    """FLOPs of fn(*args) (matmuls, FFTs, convolutions; every executed
    op, so loops and recompute count as often as they run), with the
    ``sharded`` modules' work times ``mesh_size`` and the rest times
    ``data_size`` (:meth:`Counter.global_flops`)."""
    with Counter(sharded) as c:
        fn(*args)
    return c.global_flops(mesh_size, data_size)


def analytic_bytes(fn, *args, mesh_size: int = 1, data_size: int = 1,
                   sharded=()) -> int:
    """HBM-traffic estimate: every counted op reads its operands and
    writes its result once, plus one read of the tensor arguments and one
    write of the outputs (the reference's ``analytic_bytes``)."""
    with Counter(sharded) as c:
        out = fn(*args)
    io = sum(_nbytes(t) for t in tree_flatten((args, out))[0]
             if isinstance(t, torch.Tensor))
    return c.global_bytes(mesh_size, data_size) + io
