"""The tree fold of the silent-corruption sentinel: a hand-written CUDA
kernel, its plain version and the wrapper that picks between them.

Replaces ``galvatron_tpu/runtime/sdc.py::tree_fold_metrics``, the ``jnp``
loop the JAX package runs in every step under ``--sdc_check``: for a list
of tensors (the leaves of a parameter tree) it returns

- ``fold``: the wraparound sum, mod 2^32, of every leaf's uint32 words
  (``_leaf_bits_u32``: a 1- or 2-byte element zero-extended to a word of its
  own, an 8-byte element split into two words, ``bool`` as ``uint8``; a bf16
  pair is NOT one word). Exact and invariant to order, sharding and
  stacking, so the same state gives the same fold under any layout;
- ``sumsq``: the fp32 sum of squares of the floating leaves, a magnitude
  trend for telemetry, not order-exact and never compared.

`tree_fold` is the wrapper: on CPU tensors it computes the plain version
`tree_fold_reference`; on CUDA tensors it launches ``csrc/tree_fold.cu``
(one launch for the whole list, built with ``nvcc`` for sm_90a at first use
into ``build/galvatron_tpu_torch/`` like the flash kernels, loaded with
``ctypes``) or raises: a missing ``nvcc``, a failed build or launch, mixed
devices or a non-contiguous leaf. It never gives way to the plain version.
``tree_fold.launches`` counts the kernel's launches.

The kernel reads every byte once: its bound is the tree's bytes / 3.35
TB/s (H100 SXM HBM3).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterable, List, Sequence, Tuple

import torch

from galvatron_tpu_torch.ops import flash_attention as _flash

SOURCE = os.path.join(_flash._PKG_DIR, "csrc", "tree_fold.cu")
MASK32 = (1 << 32) - 1
BLOCKS_PER_SM = 8

# the kernel's float kinds
_FLOAT_KINDS = {torch.float32: 1, torch.bfloat16: 2, torch.float16: 3, torch.float64: 4}


# ----------------------------------------------------------- plain version
def leaf_words(x: torch.Tensor) -> torch.Tensor:
    """`x`'s uint32 words as int64 values in [0, 2^32): one word per 1-, 2-
    or 4-byte element (zero-extended), two per 8-byte element; ``bool`` as
    ``uint8``. Flat; on `x`'s device."""
    x = x.detach().reshape(-1)
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    size = x.element_size()
    if x.is_complex():
        raise TypeError("tree fold: complex leaves are not folded (%s)" % x.dtype)
    if size == 1:
        return x.view(torch.uint8).to(torch.int64)
    if size == 2:
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    if size == 4:
        return x.view(torch.int32).to(torch.int64) & MASK32
    if size == 8:
        v = x.view(torch.int64)
        return torch.stack([v & MASK32, (v >> 32) & MASK32], 1).reshape(-1)
    raise TypeError("tree fold: unsupported element size %d (%s)" % (size, x.dtype))


def tree_fold_reference(leaves: Iterable[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fold as an int64 scalar in [0, 2^32), sumsq as an fp32 scalar) of
    `leaves`, in plain PyTorch on their device (CPU if there are none). The
    int64 sums may wrap mod 2^64, which 2^32 divides."""
    leaves = list(leaves)
    dev = leaves[0].device if leaves else torch.device("cpu")
    fold = torch.zeros((), dtype=torch.int64, device=dev)
    sumsq = torch.zeros((), dtype=torch.float32, device=dev)
    for x in leaves:
        if not x.numel():
            continue
        fold = (fold + leaf_words(x).sum()) & MASK32
        if x.is_floating_point():
            sumsq = sumsq + x.detach().float().square().sum()
    return fold, sumsq


# ------------------------------------------------------------------ kernel
_KERNEL = _flash._KernelLibrary(SOURCE, "galv_tree_fold", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
])
_TABLES: dict = {}  # device -> (key, table on the device, n_tiles): the last tree's
_SMS: dict = {}


def _tile(lib) -> int:
    fn = lib.galv_tree_fold_tile
    fn.restype = ctypes.c_longlong
    return int(fn())


def _table(leaves: Sequence[torch.Tensor], tile: int, dev: torch.device):
    """The kernel's leaf table on `dev` (cached for the last tree: a train
    step folds the same parameters in place, step after step)."""
    key = tuple((t.data_ptr(), t.numel(), t.dtype) for t in leaves)
    hit = _TABLES.get(dev)
    if hit is not None and hit[0] == key:
        return hit[1], hit[2]
    rows, first = [], 0
    for t in leaves:
        rows.append([t.data_ptr(), t.numel(), first, t.element_size(),
                     _FLOAT_KINDS.get(t.dtype, 0), 0])
        first += -(-t.numel() // tile)
    table = torch.tensor(rows, dtype=torch.int64).to(dev)
    _TABLES[dev] = (key, table, first)
    return table, first


def _check_cuda_leaves(leaves: List[torch.Tensor]) -> torch.device:
    dev = leaves[0].device
    for t in leaves:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("tree fold kernel: every leaf must be on one CUDA device, got %s"
                             % sorted({str(x.device) for x in leaves}))
        if not t.is_contiguous():
            raise ValueError("tree fold kernel: leaves must be contiguous (a %s %s view)"
                             % (t.dtype, tuple(t.shape)))
        if t.is_complex() or t.element_size() not in (1, 2, 4, 8):
            raise ValueError("tree fold kernel: unsupported leaf dtype %s" % t.dtype)
    return dev


def tree_fold(leaves: Iterable[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fold int64 scalar, sumsq fp32 scalar) of `leaves`, on their device
    and without a host sync. CPU leaves take `tree_fold_reference`; CUDA
    leaves launch the kernel once for all of them, or raise."""
    leaves = [t.detach() for t in leaves]
    if not leaves or all(t.device.type == "cpu" for t in leaves):
        return tree_fold_reference(leaves)
    dev = _check_cuda_leaves(leaves)
    leaves = [t for t in leaves if t.numel()]
    if not leaves:
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros((), dtype=torch.float32, device=dev))
    lib = _KERNEL.get()
    table, n_tiles = _table(leaves, _tile(lib), dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    out = torch.empty(2, dtype=torch.int32, device=dev)
    rc = lib.galv_tree_fold(table.data_ptr(), len(leaves), n_tiles, out.data_ptr(),
                            _SMS[index] * BLOCKS_PER_SM, index,
                            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("tree fold kernel launch failed (%d): %s"
                           % (rc, lib.galv_cuda_error_string(rc).decode()))
    tree_fold.launches += 1
    return out[0].to(torch.int64) & MASK32, out.view(torch.float32)[1]


tree_fold.launches = 0


def tree_bytes(leaves: Iterable[torch.Tensor]) -> int:
    """The bytes the fold reads: its bound is this over the memory rate."""
    return sum(t.numel() * t.element_size() for t in leaves)
