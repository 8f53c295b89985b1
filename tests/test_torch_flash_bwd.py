"""Port parity, flash-attention backward: the plain version of the
hand-written backward kernel against the Pallas backward itself (``jax.vjp``
of ``_pallas_flash`` in interpret mode) on ALL rows, and the autograd
Function against autograd of the plain forward. The kernel is held against
its plain version by tests/test_torch_cuda.py, on a CUDA machine.

Why the Pallas backward and not the XLA path: with key padding lowered to
segment ids, padded query rows attend the pad segment, while under the
additive bias they attend valid keys; their cotangent then reaches valid
keys' dk/dv differently. The two agree on dq of valid rows only."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.ops import attention as JA
from galvatron_tpu_torch.ops import attention as TA
from galvatron_tpu_torch.ops import flash_attention as TF

_ATOL = 1e-5  # fp32 both sides: the kernels' tiled sums against one einsum


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _padding_bias(b, s, pad):
    mask = np.ones((b, s), np.float32)
    for i, n in enumerate(pad):
        if n:
            mask[i, -n:] = 0.0
    return mask, (1.0 - mask)[:, None, None, :] * -1e9


@pytest.mark.parametrize("causal,padded", [(True, False), (True, True), (False, False),
                                           (False, True)])
def test_flash_bwd_plain_matches_pallas_backward_all_rows(causal, padded):
    import jax.experimental.pallas.tpu as pltpu

    b, s, nh, hd = 2, 256, 2, 128
    q, k, v = (_np((b, s, nh, hd), 30 + i) for i in range(3))
    do = _np((b, s, nh, hd), 33)
    scale = hd ** -0.5
    jseg = tseg = None
    if padded:
        _, bias = _padding_bias(b, s, (64, 128))
        jseg = JA.padding_bias_to_segment_ids(jnp.asarray(bias))
        ids = TA.padding_bias_to_segment_ids(_t(bias))
        tseg = TF.SegmentIds(q=ids, kv=ids)
    with pltpu.force_tpu_interpret_mode():
        want_out, vjp = jax.vjp(
            lambda q_, k_, v_: JA._pallas_flash(q_, k_, v_, causal=causal, sm_scale=scale,
                                                segment_ids=jseg),
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = vjp(jnp.asarray(do))
    out, lse = TF.flash_attention_fwd_reference(_t(q), _t(k), _t(v), causal=causal,
                                                sm_scale=scale, segment_ids=tseg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=3e-5)
    got = TF.flash_attention_bwd_reference(_t(q), _t(k), _t(v), out, lse, _t(do), causal=causal,
                                           sm_scale=scale, segment_ids=tseg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (b, s, nh, hd)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=_ATOL, err_msg=name)


def test_flash_bwd_plain_matches_xla_autodiff_where_the_masks_agree():
    """With a zero cotangent on padded rows, segment ids and the additive
    bias give the same gradients on every valid row and key."""
    b, s, nh, hd = 1, 128, 2, 128
    q, k, v = (_np((b, s, nh, hd), 40 + i) for i in range(3))
    mask, bias = _padding_bias(b, s, (40,))
    do = _np((b, s, nh, hd), 43) * mask[:, :, None, None]
    scale = hd ** -0.5
    _, vjp = jax.vjp(lambda q_, k_, v_: JA._xla_attention(q_, k_, v_, causal=True, sm_scale=scale,
                                                           bias=jnp.asarray(bias)),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    ids = TA.padding_bias_to_segment_ids(_t(bias))
    seg = TF.SegmentIds(q=ids, kv=ids)
    out, lse = TF.flash_attention_fwd_reference(_t(q), _t(k), _t(v), causal=True, sm_scale=scale,
                                                segment_ids=seg)
    got = TF.flash_attention_bwd_reference(_t(q), _t(k), _t(v), out, lse, _t(do), causal=True,
                                           sm_scale=scale, segment_ids=seg)
    valid = mask[0] > 0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy()[:, valid], np.asarray(w)[:, valid], atol=_ATOL,
                                   err_msg=name)


def test_flash_bwd_plain_rounds_like_the_kernel_in_bf16():
    """bf16 inputs: gradients come back in bf16, p and ds rounded to bf16
    before the second products, the products accumulated in fp32."""
    b, s, nh, hd = 1, 128, 2, 128
    q, k, v, do = (torch.from_numpy(_np((b, s, nh, hd), 50 + i)).to(torch.bfloat16)
                   for i in range(4))
    out, lse = TF.flash_attention_fwd_reference(q, k, v, causal=True, sm_scale=0.1)
    dq, dk, dv = TF.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True, sm_scale=0.1)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    fq, fk, fv = TF.flash_attention_bwd_reference(q.float(), k.float(), v.float(), out.float(),
                                                  lse, do.float(), causal=True, sm_scale=0.1)
    # the bf16 roundings of p and ds cost about 2^-8 relative of each term
    for g, f in ((dq, fq), (dk, fk), (dv, fv)):
        assert (g.float() - f).abs().max().item() <= 0.02 * f.abs().max().item()


def test_flash_autograd_function_gradcheck_float64():
    """The plain versions keep float64 in float64, so gradcheck can hold the
    Function's backward against finite differences of its forward (a tiny
    shape: gradcheck perturbs every input element)."""
    b, s, nh, hd = 1, 12, 2, 4
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, nh, hd, generator=gen, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    ids = torch.ones(b, s, dtype=torch.int32)
    ids[0, -4:] = 0
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: TF.FlashAttention.apply(q_, k_, v_, True, 0.3, ids, ids),
        (q, k, v), eps=1e-6, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("padded", [False, True])
def test_flash_autograd_function_matches_autograd_of_plain_forward(padded):
    b, s, nh, hd = 2, 128, 2, 128
    q, k, v = (_t(_np((b, s, nh, hd), 60 + i)).requires_grad_() for i in range(3))
    do = _t(_np((b, s, nh, hd), 63))
    ids = torch.ones(b, s, dtype=torch.int32)
    if padded:
        ids[1, -50:] = 0
    seg = TF.SegmentIds(ids, ids) if padded else None
    n_fwd, n_bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    out = TF.FlashAttention.apply(q, k, v, True, 0.2, *(seg if padded else (None, None)))
    got = torch.autograd.grad(out, (q, k, v), do)
    ref_out, _ = TF.flash_attention_fwd_reference(q, k, v, causal=True, sm_scale=0.2,
                                                  segment_ids=seg)
    want = torch.autograd.grad(ref_out, (q, k, v), do)
    assert (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches) == (n_fwd, n_bwd)
    torch.testing.assert_close(out, ref_out, atol=1e-6, rtol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=_ATOL, rtol=1e-5)


def test_core_attention_flash_branch_backpropagates_through_gqa():
    """The flash branch of core_attention with GQA heads: gradients reach
    the kv heads summed over their repeats, equal to autograd of the plain
    einsum path on valid rows with padded rows' cotangent zeroed."""
    b, s, nh, nkv, hd = 1, 256, 4, 2, 128
    q = _t(_np((b, s, nh, hd), 70)).requires_grad_()
    k, v = (_t(_np((b, s, nkv, hd), 71 + i)).requires_grad_() for i in range(2))
    mask, bias = _padding_bias(b, s, (56,))
    do = _t(_np((b, s, nh, hd), 73) * mask[:, :, None, None])
    got = torch.autograd.grad(TA.core_attention(q, k, v, causal=True, bias=_t(bias),
                                                bias_type="key_padding"), (q, k, v), do)
    want = torch.autograd.grad(TA.core_attention(q, k, v, causal=True, bias=_t(bias), impl="xla"),
                               (q, k, v), do)
    valid = torch.from_numpy(mask[0] > 0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g[:, valid], w[:, valid], atol=_ATOL, rtol=1e-5)
