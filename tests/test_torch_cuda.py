"""The port's hand-written CUDA kernel on the card: the flash-attention
forward against its plain version, its argument checks, and a serve run
whose prefills go through it. Every test is marked ``cuda`` and skips where
there is no GPU or no nvcc, from inside the test.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from galvatron_tpu_torch.cli import serve as S
from galvatron_tpu_torch.ops import flash_attention as TF

pytestmark = [pytest.mark.cuda]

# elementwise |out - ref| <= atol + rtol * |ref|. bf16: one output ulp is
# 2^-8 relative, and the tensor-core path rounds p to bf16 before P.V as the
# Pallas kernel does. fp32 inputs: only the summation order differs.
TOL_BF16, RTOL_BF16 = 2e-2, 1e-2
TOL_FP32, RTOL_FP32 = 1e-4, 0.0
TOL_LSE = 1e-3


def _need_cuda_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU or interpret mode")
    try:
        TF.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


def _close(out, ref, atol, rtol):
    return bool(((out.float() - ref.float()).abs() <= atol + rtol * ref.float().abs()).all())


def _rand(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


@pytest.mark.parametrize("s,hd,padded,causal,dtype", [
    (128, 128, False, True, torch.bfloat16),
    (512, 128, True, True, torch.bfloat16),
    (256, 256, True, False, torch.bfloat16),
    (256, 128, False, False, torch.bfloat16),
    (384, 128, True, True, torch.float32),
])
def test_flash_kernel_matches_plain_version(s, hd, padded, causal, dtype):
    """Kernel vs its plain version on the same inputs, every row, including
    padded query rows (they attend within the pad segment in both)."""
    _need_cuda_kernel()
    b, nh = 2, 4
    q, k, v = (_rand((b, s, nh, hd), 21 + i, dtype) for i in range(3))
    seg = None
    if padded:
        ids = torch.ones((b, s), dtype=torch.int32, device="cuda")
        ids[0, s - s // 4 - 5:] = 0
        seg = TF.SegmentIds(q=ids, kv=ids)
    n0 = TF.flash_attention_fwd.launches
    out, lse = TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=hd ** -0.5,
                                      segment_ids=seg)
    torch.cuda.synchronize()
    assert TF.flash_attention_fwd.launches == n0 + 1
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v, causal=causal, sm_scale=hd ** -0.5,
                                                    segment_ids=seg)
    tol = (TOL_BF16, RTOL_BF16) if dtype == torch.bfloat16 else (TOL_FP32, RTOL_FP32)
    assert out.dtype == dtype and tuple(out.shape) == (b, s, nh, hd)
    assert _close(out, ref, *tol)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


def test_flash_kernel_reads_strided_bsnh_in_place():
    """q/k/v as slices of one fused (B, S, 3, H, D) projection, as the
    model hands them over: no copies, same result as contiguous inputs."""
    _need_cuda_kernel()
    qkv = _rand((1, 256, 3, 4, 128), 5, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, _ = TF.flash_attention_fwd(q, k, v, causal=True, sm_scale=0.1)
    ref, _ = TF.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=True, sm_scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_unaligned_bf16_rows_take_the_cuda_core_path(causal):
    """bf16 rows that are not 16-byte aligned cannot feed the tensor-core
    path's vector loads; the CUDA-core kernel takes them, same results."""
    _need_cuda_kernel()
    b, s, nh, hd = 1, 256, 4, 128
    bufs = [_rand((b, s, nh, hd + 1), 31 + i, torch.bfloat16) for i in range(3)]
    q, k, v = (t[..., 1:] for t in bufs)  # 2-byte offset, odd row stride
    assert q.data_ptr() % 16 != 0 and q.stride(-1) == 1
    ids = torch.ones((b, s), dtype=torch.int32, device="cuda")
    ids[0, 200:] = 0
    seg = TF.SegmentIds(q=ids, kv=ids)
    out, lse = TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=0.1, segment_ids=seg)
    torch.cuda.synchronize()
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v, causal=causal, sm_scale=0.1,
                                                    segment_ids=seg)
    assert _close(out, ref, TOL_BF16, RTOL_BF16)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("bad", ["head_dim", "seq", "dtype", "device", "gqa"])
def test_flash_kernel_refuses_what_it_does_not_take(bad):
    _need_cuda_kernel()
    q = torch.zeros(1, 128, 2, 128, device="cuda", dtype=torch.bfloat16)
    k = v = q
    if bad == "head_dim":
        q = k = v = torch.zeros(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16)
    elif bad == "seq":
        q = k = v = torch.zeros(1, 100, 2, 128, device="cuda", dtype=torch.bfloat16)
    elif bad == "dtype":
        q = k = v = q.half()
    elif bad == "device":
        k = q.cpu()
    elif bad == "gqa":
        k = v = torch.zeros(1, 128, 1, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TF.flash_attention_fwd(q, k, v, causal=True, sm_scale=0.1)


def test_serve_on_cuda_prefills_through_the_flash_kernel():
    _need_cuda_kernel()
    argv = [
        "--device", "cuda", "--model_type", "llama", "--set_model_config_manually", "1",
        "--hidden_size", "256", "--num_attention_heads", "2", "--ffn_hidden_size", "256",
        "--num_layers", "2", "--vocab_size", "64", "--seq_length", "256",
        "--serve_max_concurrency", "2", "--serve_page_size", "128",
        "--num_requests", "3", "--prompt_len_min", "100", "--prompt_len_max", "200",
        "--max_new_tokens", "3",
    ]
    n0 = TF.flash_attention_fwd.launches
    summary = S.main(argv)
    assert summary["requests"] == 3 and summary["shed"] == 0
    assert TF.flash_attention_fwd.launches - n0 == 2 * 3  # layers x prefills
