"""Which kernel route the flash-attention wrappers take, decided in Python
from the inputs alone (`flash_route`), the build key that covers the headers
a kernel source includes, and how `tools/profile_train` sorts the kernels'
names. Runs on the CPU: no kernel is built or launched here."""

import os
import shutil

import pytest
import torch

from galvatron_tpu_torch.ops import flash_attention as TF
from galvatron_tpu_torch.tools.profile_train import kind_of

BF16 = torch.bfloat16


def _bsnh(b, s, h, d, dtype=BF16):
    return torch.empty((b, s, h, d), dtype=dtype)


@pytest.mark.parametrize("b", [1, 4])
def test_main_path_shapes_take_wgmma(b):
    q, k, v, out, do = (_bsnh(b, 2048, 32, 128) for _ in range(5))
    assert TF.flash_route([q, k, v]) == "wgmma"
    assert TF.flash_route([q, k, v, out, do], backward=True) == "wgmma"


def test_fused_qkv_view_takes_wgmma():
    qkv = torch.empty((1, 256, 3, 4, 128), dtype=BF16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous() and q.stride(1) == 3 * 4 * 128
    assert TF.flash_route([q, k, v]) == "wgmma"
    assert TF.flash_route([q, k, v, q, k], backward=True) == "wgmma"


@pytest.mark.parametrize("how", ["base", "row_stride", "head_stride"])
def test_rows_tma_cannot_read_take_cuda_core(how):
    if how == "base":  # 8 bytes past a 16-byte boundary
        flat = torch.empty(1 * 256 * 4 * 128 + 4, dtype=BF16)
        q = flat[4:].view(1, 256, 4, 128)
        assert q.data_ptr() % 16 == 8
    elif how == "row_stride":  # rows 132 * 4 elements apart: 8 bytes off
        q = torch.empty((1, 256, 4, 132), dtype=BF16)[..., :128]
    else:  # heads 129 elements apart, as a slice of a wider buffer leaves them
        q = torch.empty((1, 256, 4, 129), dtype=BF16)[..., 1:]
    k = v = _bsnh(1, 256, 4, 128)
    assert q.stride(-1) == 1
    assert TF.flash_route([q, k, v]) == "cuda_core"
    assert TF.flash_route([k, q, v]) == "cuda_core"
    assert TF.flash_route([k, k, v, k, q], backward=True) == "cuda_core"


def test_fp32_takes_cuda_core():
    q = _bsnh(1, 512, 4, 128, torch.float32)
    assert TF.flash_route([q, q, q]) == "cuda_core"
    assert TF.flash_route([q] * 5, backward=True) == "cuda_core"


def test_head_dim_256_forward_mma_backward_cuda_core():
    q = _bsnh(1, 512, 4, 256)
    assert TF.flash_route([q, q, q]) == "mma"
    assert TF.flash_route([q] * 5, backward=True) == "cuda_core"


def test_seq_576_takes_wgmma():
    # 576 = 4 * 128 + 64: the 128-row tiles' last half lies past the end
    q = _bsnh(1, 576, 8, 128)
    assert TF.flash_route([q, q, q]) == "wgmma"
    assert TF.flash_route([q] * 5, backward=True) == "wgmma"


def test_unknown_route_is_refused():
    with pytest.raises(ValueError, match="route"):
        TF._route_code("tensor_core")
    assert [TF._route_code(r) for r in TF.ROUTES] == [0, 1, 2]


def test_build_key_covers_included_headers(tmp_path):
    csrc = os.path.join(os.path.dirname(TF.SOURCE))
    for name in os.listdir(csrc):
        shutil.copy(os.path.join(csrc, name), tmp_path / name)
    for source in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        src = str(tmp_path / source)
        assert TF._included_headers(src) == [str(tmp_path / "sm90.cuh")]
        before = TF.library_path(src)
        assert TF.library_path(src) == before
        header = tmp_path / "sm90.cuh"
        text = header.read_text()
        header.write_text(text + "\n// edited\n")
        try:
            assert TF.library_path(src) != before
        finally:
            header.write_text(text)
        assert TF.library_path(src) == before


@pytest.mark.parametrize("name,kind", [
    ("void (anonymous namespace)::flash_fwd_wgmma_kernel((anonymous namespace)::Params, "
     "(anonymous namespace)::FwdMaps)", "flash_attn_fwd"),
    ("void (anonymous namespace)::flash_fwd_mma_kernel<256>((anonymous namespace)::Params)",
     "flash_attn_fwd"),
    ("void (anonymous namespace)::dkv_wgmma_kernel((anonymous namespace)::BwdParams, "
     "(anonymous namespace)::BwdMaps)", "flash_attn_bwd"),
    ("void (anonymous namespace)::dq_wgmma_kernel((anonymous namespace)::BwdParams, "
     "(anonymous namespace)::BwdMaps)", "flash_attn_bwd"),
    ("void (anonymous namespace)::di_kernel<__nv_bfloat16, 128>((anonymous "
     "namespace)::BwdParams)", "flash_attn_bwd"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTT", "matmul"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "collective"),
])
def test_profile_train_sorts_the_kernels_by_name(name, kind):
    assert kind_of(name) == kind
