"""Flash attention: hand-written CUDA kernels for the forward and the backward,
their plain versions, and the autograd Function that joins them.

Replaces the TPU kernel ``galvatron_tpu/ops/attention.py::_pallas_flash``
(jax.experimental.pallas.ops.tpu.flash_attention): its forward ``pallas_call``
becomes ``csrc/flash_attn_fwd.cu``, its two backward ``pallas_call``s (dkv and
dq) become ``csrc/flash_attn_bwd.cu``, both for sm_90a, sharing the Hopper
building blocks of ``csrc/sm90.cuh``. `flash_route` picks the kernel from the
inputs and the C side obeys it: ``"wgmma"`` (bf16, head_dim 128, rows TMA can
read: the serve and train paths) runs TMA + mbarrier + ``wgmma`` kernels with
a producer warp; ``"mma"`` (forward only, bf16 head_dim 256 with aligned rows)
runs ``mma.sync`` on the tensor cores; ``"cuda_core"`` (everything else) runs
fp32 FMAs. Each source's header note gives the bound and the design. Each
source is compiled with ``nvcc`` into a shared library with a plain C
interface at first use, keyed by a hash of the source, the headers it
includes and the flags, under ``build/galvatron_tpu_torch/`` beside the
package, and loaded with ``ctypes``.

`flash_attention_fwd` and `flash_attention_bwd` are the wrappers: on CPU
tensors they compute the plain versions `flash_attention_fwd_reference` and
`flash_attention_bwd_reference`; on CUDA tensors they launch the kernel of
their route or raise (bad argument, a forced route that does not take the
inputs, no ``nvcc``, build or launch failure) — there is no fallback. Each
wrapper's ``launches`` attribute counts its kernel launches, ``routes``
counts them by route and ``last_route`` names the route of the last
launch. `FlashAttention` is the ``torch.autograd.Function`` whose forward
is the forward wrapper and whose backward is the backward wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

HEAD_DIMS = (128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 64  # query and key tile rows: sequence lengths must be multiples

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "flash_attn_fwd.cu")
BWD_SOURCE = os.path.join(_PKG_DIR, "csrc", "flash_attn_bwd.cu")
SOURCES = (SOURCE, BWD_SOURCE)
ROUTES = ("cuda_core", "mma", "wgmma")  # index = the route code of the C entry points
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "galvatron_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class SegmentIds(NamedTuple):
    """Per-token int32 segment ids, (B, Sq) for queries and (B, Sk) for
    keys: a query attends only to keys of its own segment."""

    q: torch.Tensor
    kv: torch.Tensor


# ------------------------------------------------------------ plain versions
def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for the kernels' dtypes (bf16, fp32); float64 stays float64, so
    gradcheck can run the plain versions in double precision."""
    return torch.promote_types(dtype, torch.float32)


def _masked_logits(q, k, sm_scale, causal, segment_ids):
    """(B, H, Sq, Sk) logits in the math dtype, masked logits with
    DEFAULT_MASK_VALUE ADDED as in the Pallas kernel, so every row stays
    defined (a padded query row attends within the pad segment)."""
    acc = _math_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * sm_scale
    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if segment_ids is not None:
        mask = segment_ids.q[:, None, :, None] == segment_ids.kv[:, None, None, :]
    if causal:
        cols = torch.arange(sk, device=q.device)
        rows = torch.arange(sq, device=q.device)
        causal_mask = (cols[None, :] <= rows[:, None])[None, None]
        mask = causal_mask if mask is None else mask & causal_mask
    if mask is not None:
        logits = logits + torch.where(mask, 0.0, DEFAULT_MASK_VALUE).to(acc)
    return logits


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    sm_scale: float, segment_ids: Optional[SegmentIds] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes, in fp32 math: BSNH q (B, Sq, H, D)
    and k/v (B, Sk, H, D) -> (out (B, Sq, H, D) in q's dtype, logsumexp
    (B, H, Sq) fp32)."""
    logits = _masked_logits(q, k, sm_scale, causal, segment_ids)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(logits.dtype))
    return out.to(q.dtype), lse


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool, sm_scale: float,
    segment_ids: Optional[SegmentIds] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the backward kernel computes, in fp32 math, as the Pallas
    backward does: p = exp(logits - lse) with the forward's masks,
    di = rowsum(out * do), dv = p^T do, dp = do v^T,
    ds = p (dp - di) sm_scale, dq = ds k, dk = ds^T q. p is rounded to do's
    dtype before dv and ds to the input dtype before dq and dk; the products
    accumulate in fp32; (dq, dk, dv) come back in the input dtype."""
    logits = _masked_logits(q, k, sm_scale, causal, segment_ids)
    acc = logits.dtype
    p = torch.exp(logits - lse.to(acc)[..., None])
    dof = do.to(acc)
    di = (out.to(acc) * dof).sum(-1).permute(0, 2, 1)  # (B, H, Sq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.to(acc))
    ds = ((dp - di[..., None]) * p * sm_scale).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ the build
def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for cand in candidates:
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the flash-attention "
        "kernels are built from %s at first use on a CUDA tensor" % ", ".join(SOURCES))


def _included_headers(source: str) -> list:
    """The local headers (``#include "..."``) `source` includes, transitively,
    in the order first met."""
    seen, todo = [], [source]
    while todo:
        with open(todo.pop(0)) as f:
            names = re.findall(r'^\s*#\s*include\s*"([^"]+)"', f.read(), re.M)
        for name in names:
            path = os.path.join(os.path.dirname(source), name)
            if path not in seen:
                seen.append(path)
                todo.append(path)
    return seen


def library_path(source: str = SOURCE) -> str:
    """Where the build of `source` with the current flags goes: keyed by the
    source, every local header it includes and the flags, so an edited
    header never reuses a stale build."""
    h = hashlib.sha256()
    for path in [source] + _included_headers(source):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, "%s_%s.so" % (stem, h.hexdigest()[:16]))


def build(source: str = SOURCE) -> str:
    """Compile `source` if it has no build yet; returns the path of the
    shared library. The compiler's output (registers, shared memory, spills
    from ``-Xptxas -v``) is kept beside it as ``.log``."""
    so = library_path(source)
    if os.path.exists(so):
        return so
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d) on %s:\n%s" % (proc.returncode, source, log))
        with open(so + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


class _KernelLibrary:
    """One source's shared library, built and loaded once per process."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source, self.symbol, self.argtypes = source, symbol, list(argtypes)
        self._lock = threading.Lock()
        self._lib = None

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build(self.source))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                lib.galv_cuda_error_string.argtypes = [ctypes.c_int]
                lib.galv_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


_P, _I = ctypes.c_void_p, ctypes.c_int
_KERNEL = _KernelLibrary(SOURCE, "galv_flash_attn_fwd", [
    _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
    _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P,
])
_BWD_KERNEL = _KernelLibrary(BWD_SOURCE, "galv_flash_attn_bwd", [
    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong),
    _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _P,
])


# ---------------------------------------------------------------- the wrappers
def _tma_rows(t: torch.Tensor) -> bool:
    """Base 16-byte aligned and every (batch, seq, head) stride a multiple of
    8 elements: TMA's rule (global address and byte strides multiples of 16)."""
    sb, ss, sh = t.stride()[:3]
    return (t.data_ptr() % 16 | sb % 8 | ss % 8 | sh % 8) == 0


def flash_route(tensors: Sequence[torch.Tensor], *, backward: bool = False) -> str:
    """The kernel route for BSNH `tensors` (q, k, v, then for the backward
    out and do): ``"wgmma"`` for bf16, head_dim 128, every sequence length a
    multiple of 64 and every tensor TMA-readable (`_tma_rows`); ``"mma"``
    (forward only) for bf16 head_dim 256 with the same rows; else
    ``"cuda_core"``."""
    q = tensors[0]
    if q.dtype != torch.bfloat16 or not all(map(_tma_rows, tensors)):
        return "cuda_core"
    if q.shape[-1] == 128 and all(t.shape[1] % BLOCK == 0 for t in tensors):
        return "wgmma"
    if q.shape[-1] == 256 and not backward:
        return "mma"
    return "cuda_core"


def _route_code(route: str) -> int:
    if route not in ROUTES:
        raise ValueError("flash attention route must be one of %s, got %r" % (ROUTES, route))
    return ROUTES.index(route)


def _check_cuda_args(q, k, v, segment_ids):
    tensors = [q, k, v] + (list(segment_ids) if segment_ids is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash attention: q, k, v and segment ids must share one "
                         "device, got %s" % [str(t.device) for t in tensors])
    if q.device.type != "cuda":
        raise ValueError("flash attention kernel needs CUDA tensors, got %s" % q.device)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash attention takes float32 or bfloat16 q/k/v of one "
                         "dtype, got %s %s %s" % (q.dtype, k.dtype, v.dtype))
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes BSNH (B, S, heads, head_dim) tensors")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError("flash attention: q %s, k %s, v %s do not match (expand "
                         "GQA heads before the call)" % (tuple(q.shape), tuple(k.shape),
                                                         tuple(v.shape)))
    if d not in HEAD_DIMS:
        raise ValueError("flash attention kernel is built for head_dim %s, got %d"
                         % (HEAD_DIMS, d))
    if sq % BLOCK or sk % BLOCK:
        raise ValueError("flash attention kernel needs sequence lengths that are "
                         "multiples of %d, got q %d, kv %d" % (BLOCK, sq, sk))
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash attention needs a contiguous head_dim")
    if segment_ids is not None:
        for name, ids, s in (("q", segment_ids.q, sq), ("kv", segment_ids.kv, sk)):
            if ids.dtype != torch.int32 or tuple(ids.shape) != (b, s) or not ids.is_contiguous():
                raise ValueError("flash attention: %s segment ids must be contiguous int32 "
                                 "(%d, %d), got %s %s" % (name, b, s, ids.dtype,
                                                          tuple(ids.shape)))


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _raise_on(rc: int, lib, what: str, route: str) -> None:
    if rc == -1:
        raise ValueError("flash attention %s: route %r does not take these inputs (%s)"
                         % (what, route, lib.galv_cuda_error_string(rc).decode()))
    if rc != 0:
        raise RuntimeError("flash attention %s kernel launch failed on route %r (%d): %s"
                           % (what, route, rc, lib.galv_cuda_error_string(rc).decode()))


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    sm_scale: float, segment_ids: Optional[SegmentIds] = None, route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D), logsumexp (B, H, Sq) fp32). CPU tensors take the
    plain version; CUDA tensors launch the kernel of `route` (default
    `flash_route`) on the current stream; a route that does not take the
    inputs raises."""
    if _on_cpu([q, k, v] + (list(segment_ids) if segment_ids is not None else [])):
        return flash_attention_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                             segment_ids=segment_ids)
    _check_cuda_args(q, k, v, segment_ids)
    route = route or flash_route([q, k, v])
    code = _route_code(route)
    lib = _KERNEL.get()
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    rc = lib.galv_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        segment_ids.q.data_ptr() if segment_ids is not None else None,
        segment_ids.kv.data_ptr() if segment_ids is not None else None,
        strides, b, h, sq, k.shape[1], d, _DTYPE_CODES[q.dtype], float(sm_scale),
        int(bool(causal)), code, _device_index(q), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, lib, "forward", route)
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[route] = flash_attention_fwd.routes.get(route, 0) + 1
    flash_attention_fwd.last_route = route
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.routes = {}
flash_attention_fwd.last_route = None


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool, sm_scale: float,
    segment_ids: Optional[SegmentIds] = None, route: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), BSNH in the input dtype, from the forward's inputs, its
    out and logsumexp, and the cotangent `do` of out. CPU tensors take the
    plain version; CUDA tensors launch the kernels of `route` (default
    `flash_route`) on the current stream; a route that does not take the
    inputs raises."""
    seg = list(segment_ids) if segment_ids is not None else []
    if _on_cpu([q, k, v, out, lse, do] + seg):
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal,
                                             sm_scale=sm_scale, segment_ids=segment_ids)
    _check_cuda_args(q, k, v, segment_ids)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    for name, t in (("out", out), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape or t.stride(-1) != 1:
            raise ValueError("flash attention backward: %s must be a %s %s tensor on %s with "
                             "a contiguous head_dim, got %s %s on %s"
                             % (name, q.dtype, tuple(q.shape), q.device, t.dtype,
                                tuple(t.shape), t.device))
    if (lse.device != q.device or lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, sq)
            or not lse.is_contiguous()):
        raise ValueError("flash attention backward: lse must be contiguous float32 "
                         "(%d, %d, %d) on %s" % (b, h, sq, q.device))
    route = route or flash_route([q, k, v, out, do], backward=True)
    code = _route_code(route)
    lib = _BWD_KERNEL.get()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    di = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, out, do, dq, dk, dv) for s in t.stride()[:3]))
    rc = lib.galv_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(),
        segment_ids.q.data_ptr() if segment_ids is not None else None,
        segment_ids.kv.data_ptr() if segment_ids is not None else None,
        strides, b, h, sq, sk, d, _DTYPE_CODES[q.dtype], float(sm_scale), int(bool(causal)),
        code, _device_index(q), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, lib, "backward", route)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[route] = flash_attention_bwd.routes.get(route, 0) + 1
    flash_attention_bwd.last_route = route
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = {}
flash_attention_bwd.last_route = None


class FlashAttention(torch.autograd.Function):
    """out = flash attention(q, k, v) with the kernels on both passes: the
    forward saves (q, k, v, out, lse) and the backward feeds them to
    `flash_attention_bwd` (the counterpart of the Pallas kernel's
    ``jax.custom_vjp``). Segment ids are (B, S) int32 or None."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_seg=None, kv_seg=None):
        seg = SegmentIds(q_seg, kv_seg) if q_seg is not None else None
        out, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                       segment_ids=seg)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        seg = SegmentIds(q_seg, kv_seg) if q_seg is not None else None
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=ctx.causal,
                                         sm_scale=ctx.sm_scale, segment_ids=seg)
        return dq, dk, dv, None, None, None, None
