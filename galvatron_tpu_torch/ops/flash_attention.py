"""Flash-attention forward: a hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``galvatron_tpu/ops/attention.py::_pallas_flash``
(forward of jax.experimental.pallas.ops.tpu.flash_attention). The kernel
source is ``csrc/flash_attn_fwd.cu`` (sm_90a); its header note gives the
bound and the design: bf16 inputs with 16-byte-aligned rows run on the
tensor cores, fp32 inputs and unaligned bf16 rows on the CUDA cores. It is compiled with ``nvcc`` into a shared library
with a plain C interface at first use, keyed by a hash of the source and the
flags, under ``build/galvatron_tpu_torch/`` beside the package, and loaded
with ``ctypes``.

`flash_attention_fwd` is the wrapper: on CPU tensors it computes the plain
version `flash_attention_fwd_reference`; on CUDA tensors it launches the
kernel or raises (bad argument, no ``nvcc``, build or launch failure) —
there is no fallback. ``flash_attention_fwd.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import NamedTuple, Optional, Tuple

import torch

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

HEAD_DIMS = (128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 64  # query and key tile rows: sequence lengths must be multiples

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "flash_attn_fwd.cu")
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


# -------------------------------------------------------------- plain version
def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    sm_scale: float, segment_ids: Optional[SegmentIds] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in fp32 math: BSNH q (B, Sq, H, D) and k/v
    (B, Sk, H, D) -> (out (B, Sq, H, D) in q's dtype, logsumexp (B, H, Sq)
    fp32). Masked logits get DEFAULT_MASK_VALUE added, as in the Pallas
    kernel, so a padded query row attends within the pad segment and every
    row is defined."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
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
        logits = logits + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype), lse


# ------------------------------------------------------------------- the build
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
        "kernel is built from %s at first use on a CUDA tensor" % SOURCE)


def library_path() -> str:
    """Where the build for the current source and flags goes."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, "flash_attn_fwd_%s.so" % digest)


def build() -> str:
    """Compile the kernel if this source has no build yet; returns the path
    of the shared library. The compiler's output (registers, shared memory,
    spills from ``-Xptxas -v``) is kept beside it as ``.log``."""
    so = library_path()
    if os.path.exists(so):
        return so
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d) on %s:\n%s" % (proc.returncode, SOURCE, log))
        with open(so + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


class _KernelLibrary:
    """The loaded shared library, built and loaded once per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None

    def get(self):
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build())
                fn = lib.galv_flash_attn_fwd
                fn.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_longlong),
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p,
                ]
                fn.restype = ctypes.c_int
                lib.galv_cuda_error_string.argtypes = [ctypes.c_int]
                lib.galv_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


_KERNEL = _KernelLibrary()


# ------------------------------------------------------------------ the wrapper
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


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    sm_scale: float, segment_ids: Optional[SegmentIds] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D), logsumexp (B, H, Sq) fp32). CPU tensors take the
    plain version; CUDA tensors launch the kernel on the current stream."""
    tensors = [q, k, v] + (list(segment_ids) if segment_ids is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                             segment_ids=segment_ids)
    _check_cuda_args(q, k, v, segment_ids)
    lib = _KERNEL.get()
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    rc = lib.galv_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        segment_ids.q.data_ptr() if segment_ids is not None else None,
        segment_ids.kv.data_ptr() if segment_ids is not None else None,
        strides, b, h, sq, sk, d, _DTYPE_CODES[q.dtype], float(sm_scale), int(bool(causal)),
        q.device.index if q.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("flash attention kernel launch failed (%d): %s"
                           % (rc, lib.galv_cuda_error_string(rc).decode()))
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
