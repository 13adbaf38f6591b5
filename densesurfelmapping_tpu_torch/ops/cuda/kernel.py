"""The contract every wrapper of the port's CUDA kernels keeps (`slic.py`,
`sgm.py`, `wta.py`).

A public wrapper has the signature of its plain twin, and its body is one
call of `dispatch(twin, launch, rank, *args)`:

* on a CPU tensor the plain twin runs; operands with a leading (B,) stream
  axis (one more axis than `rank`) run it under `torch.func.vmap`;
* a CUDA tensor batched by a `torch.func.vmap` (the fuse or stereo step of
  one frame over a fleet's streams, `parallel/multistream.py`; a mesh
  cell's streams, `parallel/sharding.py`) reaches ONE launch for every
  stream through the vmap rule of `_Launch`, the kernels taking the stream
  axis on their grid;
* any other CUDA tensor launches directly; any other device raises.

A launch (a module's `_launch_*`) checks its operands (`check`, `lead`),
runs on the current stream (`stream`) and calls its C entry through its
source's `Library`, which raises on a CUDA error and counts the launch.
Nothing here builds a kernel at import.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import build


class Library:
    """One CUDA source, `csrc/<name>.cu`: its library, built and loaded at
    first use (`build.load`), and the launch count of each of its kernels
    (`launches`, which the wrapper module exposes as `LAUNCHES`)."""

    def __init__(self, name: str, signatures: dict, counts):
        self.name, self.signatures = name, signatures
        self.launches = dict.fromkeys(counts, 0)

    def load(self) -> ctypes.CDLL:
        return build.load(self.name, self.signatures)

    def reset_launch_counts(self) -> None:
        for k in self.launches:
            self.launches[k] = 0

    def launch(self, entry: str, *args, count: Optional[str] = None) -> None:
        """Call the C entry `entry`; raise on a CUDA error, else add one to
        the launch count `count` (the entry's name by default)."""
        count = count or entry
        err = getattr(self.load(), entry)(*args)
        if err != 0:
            raise RuntimeError(f"{count} launch failed with CUDA error {err}")
        self.launches[count] += 1


def _need_cuda(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA tensors, got {device}")


def stream(device: torch.device) -> int:
    """The handle of `device`'s current CUDA stream."""
    _need_cuda(device)
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, t: torch.Tensor, dtype, shape, device) -> int:
    """t's data pointer, once its device, dtype, shape (a batched call puts
    the stream count first) and layout are the kernel's."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return t.data_ptr()


def check_streams(nb: int) -> None:
    if not 1 <= nb <= 65535:
        raise ValueError(f"{nb} streams outside the grid's z range 1..65535")


def lead(name: str, t: torch.Tensor, dims: str) -> tuple:
    """((), 1) for one stream's operand of the axes `dims` ("H, W"),
    ((B,), B) for B streams'; raises for any other rank."""
    rank = dims.count(",") + 1
    if t.dim() not in (rank, rank + 1):
        raise ValueError(f"{name} must be ({dims}) or (B, {dims}), got "
                         f"{tuple(t.shape)}")
    return (tuple(t.shape[:1]), t.shape[0]) if t.dim() > rank else ((), 1)


class _Launch(torch.autograd.Function):
    """`launch(*args)` under torch.func.vmap: the vmap rule moves every
    batched tensor operand's stream axis first (contiguous), repeats an
    operand that vmap does not batch (a constant plane, such as the initial
    seed grid) for each stream, and makes ONE launch for all of them.
    Non-tensor arguments (a leading config, trailing options) and None
    operands pass as they are; every tensor output carries the stream axis
    first, whatever their number.  Operand `inplace` is written in place by
    the launch, which returns it: it must carry the stream axis, and is
    written back when vmap's view of it is not contiguous."""

    @staticmethod
    def forward(launch, inplace, *args):
        return launch(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, launch, inplace, *args):
        n = info.batch_size
        args = list(args)
        for i, (a, d) in enumerate(zip(args, in_dims[2:])):
            if not isinstance(a, torch.Tensor):
                continue
            if i == inplace:
                if d is None:
                    raise ValueError(
                        f"{launch.__name__} writes operand {i} in place: "
                        f"under vmap it must carry the stream axis")
                args[i] = a.movedim(d, 0)
            else:
                args[i] = (a.expand(n, *a.shape) if d is None
                           else a.movedim(d, 0)).contiguous()
        if inplace is not None and not args[inplace].is_contiguous():
            out = args[inplace]
            args[inplace] = out.contiguous()
            return out.copy_(launch(*args)), 0
        return launch(*args), 0


def _twin_over_streams(twin, args):
    """`twin(*args)` under torch.func.vmap over the leading stream axis of
    every tensor operand; its None outputs stay None."""
    at = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
    kept = []

    def one(*ts):
        a = list(args)
        for i, t in zip(at, ts):
            a[i] = t
        leaves, spec = tree_flatten(twin(*a))
        kept[:] = [spec, [x is not None for x in leaves]]
        return tuple(x for x in leaves if x is not None)

    outs = iter(torch.func.vmap(one)(*(args[i] for i in at)))
    spec, present = kept
    return tree_unflatten([next(outs) if p else None for p in present], spec)


def dispatch(twin, launch, rank: int, *args, inplace: Optional[int] = None):
    """A wrapper's call (the module doc): `twin(*args)` on a CPU tensor,
    `launch(*args)` on a CUDA tensor.  `rank` is the rank of one stream's
    first tensor operand; `inplace` the index of an operand the launch
    writes in place and returns."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    device = tensors[0].device
    if device.type == "cpu":
        if tensors[0].dim() > rank:
            return _twin_over_streams(twin, args)
        return twin(*args)
    _need_cuda(device)
    if any(torch._C._functorch.is_batchedtensor(t) for t in tensors):
        return _Launch.apply(launch, inplace, *args)
    return launch(*args)
