"""The check that holds the flash kernels against their plain versions on
the card (``chip_smoke.judge``, also used by tests/test_torch_cuda.py) can
fail a wrong kernel: on the CPU, the plain versions computed in float64 and
rounded to the kernels' dtype (more rounding than a kernel adds) pass it
with room to spare, and a zeroed first or last tile fails it, on every
gradient, with and without a key-padding tail."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from galvatron_tpu_torch.ops import flash_attention as TF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_kernel_check_passes_rounding_and_fails_planted_faults(kind, dtype, padded):
    b, s, nh, hd = 1, 1024, 2, 128
    rng = np.random.default_rng(3)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, s, nh, hd)).astype(np.float32))
                   .to(dtype) for _ in range(4))
    seg = None
    if padded:
        ids = (torch.arange(s) < s - s // 8 - 3).to(torch.int32)[None]
        seg = TF.SegmentIds(ids, ids)
    kw = dict(causal=True, sm_scale=hd ** -0.5, segment_ids=seg)
    out, lse = TF.flash_attention_fwd_reference(q, k, v, **kw)
    if kind == "fwd":
        tol = CS.TOL_FWD_BF16 if dtype == torch.bfloat16 else CS.TOL_FWD_FP32
        want = [out]
        exact = [TF.flash_attention_fwd_reference(q.double(), k.double(), v.double(), **kw)[0]]
    else:
        tol = CS.TOL_BWD_BF16 if dtype == torch.bfloat16 else CS.TOL_BWD_FP32
        want = TF.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
        exact = TF.flash_attention_bwd_reference(
            *(t.double() for t in (q, k, v, out, lse, do)), **kw)
    for w, x in zip(want, exact):
        n_bad, used, _, med = CS.judge(torch, x.to(dtype), w, tol)
        assert n_bad == 0 and used < 0.5, (used, med)
        for fault, wrong in CS.planted_faults(w).items():
            assert CS.judge(torch, wrong, w, tol)[0] > 0, fault
