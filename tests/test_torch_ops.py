"""Port parity, ops: norms, RoPE, repeat_kv, the plain attention path and the
flash-attention forward's plain version against the JAX reference, on the
CPU, with the same numpy inputs fed to both, and core_attention's dispatch.
The hand-written kernel itself is held against its plain version by
tests/test_torch_cuda.py, on a CUDA machine."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.ops import attention as JA
from galvatron_tpu.ops import norms as JN
from galvatron_tpu.ops import rope as JR
from galvatron_tpu_torch.ops import attention as TA
from galvatron_tpu_torch.ops import flash_attention as TF
from galvatron_tpu_torch.ops import norms as TN
from galvatron_tpu_torch.ops import rope as TR

_ATOL_OPS = 1e-5  # fp32 on both sides; sums reassociate differently
_ATOL_FLASH = 3e-5  # plain flash (one fp32 softmax) vs the Pallas online softmax


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_matches_reference():
    x, scale = _np((2, 5, 48), 0), _np((48,), 1)
    want = JN.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = TN.rms_norm(_t(x), _t(scale), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL_OPS)


def test_layer_norm_matches_reference():
    x, scale, bias = _np((2, 5, 48), 2), _np((48,), 3), _np((48,), 4)
    want = JN.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5)
    got = TN.layer_norm(_t(x), _t(scale), _t(bias), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL_OPS)


def test_norms_cast_back_to_bf16():
    x = torch.from_numpy(_np((3, 64), 5)).to(torch.bfloat16)
    assert TN.rms_norm(x, torch.ones(64)).dtype == torch.bfloat16
    assert TN.layer_norm(x, torch.ones(64), torch.zeros(64)).dtype == torch.bfloat16


@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rotary_matches_reference(interleaved):
    x = _np((2, 7, 3, 16), 6)
    pos = np.random.default_rng(7).integers(0, 500, size=(2, 7)).astype(np.int32)
    want = JR.apply_rotary(jnp.asarray(x), jnp.asarray(pos), 10000.0, interleaved=interleaved)
    got = TR.apply_rotary(_t(x), _t(pos), 10000.0, interleaved=interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL_OPS)


def test_repeat_kv_matches_reference():
    k = _np((2, 5, 2, 8), 8)
    want = JA.repeat_kv(jnp.asarray(k), 3)
    got = TA.repeat_kv(_t(k), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert TA.repeat_kv(_t(k), 1) is not None


@pytest.mark.parametrize("causal,with_bias,q_offset", [
    (True, False, 0), (False, True, 0), (True, True, 0), (True, False, 8),
])
def test_xla_attention_matches_reference(causal, with_bias, q_offset):
    b, s, nh, hd = 2, 16, 3, 8
    q, k, v = _np((b, s, nh, hd), 9), _np((b, s, nh, hd), 10), _np((b, s, nh, hd), 11)
    bias = None
    if with_bias:
        mask = np.ones((b, s), np.float32)
        mask[1, -5:] = 0
        bias = (1.0 - mask)[:, None, None, :] * -1e9
    want = JA._xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                             sm_scale=hd ** -0.5,
                             bias=None if bias is None else jnp.asarray(bias),
                             q_offset=q_offset)
    got = TA._xla_attention(_t(q), _t(k), _t(v), causal=causal, sm_scale=hd ** -0.5,
                            bias=None if bias is None else _t(bias), q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL_OPS)


def test_padding_bias_to_segment_ids_matches_reference():
    mask = np.ones((2, 256), np.float32)
    mask[0, -64:] = 0
    bias = (1.0 - mask)[:, None, None, :] * -1e9
    want = JA.padding_bias_to_segment_ids(jnp.asarray(bias))
    got = TA.padding_bias_to_segment_ids(_t(bias))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.kv))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_version_matches_pallas_interpret_all_rows(causal):
    """The plain version against the Pallas kernel itself (interpret mode),
    with key padding lowered to segment ids, on ALL rows: padded query rows
    attend within the pad segment in both."""
    import jax.experimental.pallas.tpu as pltpu

    b, s, nh, hd = 2, 256, 2, 128
    q, k, v = _np((b, s, nh, hd), 12), _np((b, s, nh, hd), 13), _np((b, s, nh, hd), 14)
    mask = np.ones((b, s), np.float32)
    mask[0, -64:] = 0.0
    mask[1, -128:] = 0.0
    bias = (1.0 - mask)[:, None, None, :] * -1e9
    seg = JA.padding_bias_to_segment_ids(jnp.asarray(bias))
    with pltpu.force_tpu_interpret_mode():
        want = JA._pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                sm_scale=hd ** -0.5, segment_ids=seg)
    ids = TA.padding_bias_to_segment_ids(_t(bias))
    got, lse = TF.flash_attention_fwd_reference(
        _t(q), _t(k), _t(v), causal=causal, sm_scale=hd ** -0.5,
        segment_ids=TF.SegmentIds(q=ids, kv=ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=_ATOL_FLASH)
    assert tuple(lse.shape) == (b, nh, s) and lse.dtype == torch.float32
    assert torch.isfinite(lse).all()


def test_flash_plain_logsumexp_is_the_softmax_normaliser():
    b, s, nh, hd = 1, 128, 2, 128
    q, k, v = _t(_np((b, s, nh, hd), 15)), _t(_np((b, s, nh, hd), 16)), _t(_np((b, s, nh, hd), 17))
    out, lse = TF.flash_attention_fwd_reference(q, k, v, causal=True, sm_scale=0.1)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.1
    logits = logits.masked_fill(~torch.tril(torch.ones(s, s, dtype=torch.bool)), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out, TA._xla_attention(q, k, v, causal=True, sm_scale=0.1),
                               atol=_ATOL_OPS, rtol=0)


# (name, seq, head_dim, kv heads, bias kind, impl, expected route)
_DISPATCH = [
    ("flash_nobias", 256, 128, 2, None, "auto", "flash"),
    ("flash_padding", 256, 128, 2, "key_padding", "auto", "flash"),
    ("flash_gqa", 128, 128, 1, "key_padding", "auto", "flash"),
    ("flash_hd256", 128, 256, 2, None, "auto", "flash"),
    ("xla_untileable_seq", 192, 128, 2, "key_padding", "auto", "xla"),
    ("xla_small_head", 256, 64, 2, None, "auto", "xla"),
    ("xla_additive_bias", 256, 128, 2, "additive", "auto", "xla"),
    ("xla_explicit", 256, 128, 2, None, "xla", "xla"),
    ("flash_explicit_additive_falls_back", 256, 128, 2, "additive", "flash", "xla"),
]


@pytest.mark.parametrize("name,s,hd,nkv,bias_kind,impl,route", _DISPATCH,
                         ids=[c[0] for c in _DISPATCH])
def test_core_attention_dispatch_on_cpu(monkeypatch, name, s, hd, nkv, bias_kind, impl, route):
    """Flash-eligible shapes reach the flash kernel's plain version on the
    CPU; every other call reaches the plain einsum path. Either way the
    result equals the reference's XLA path on the valid rows."""
    calls = []
    orig_ref, orig_xla = TF.flash_attention_fwd_reference, TA._xla_attention

    def spy_ref(*a, **kw):
        calls.append("flash")
        return orig_ref(*a, **kw)

    def spy_xla(*a, **kw):
        calls.append("xla")
        return orig_xla(*a, **kw)

    monkeypatch.setattr(TF, "flash_attention_fwd_reference", spy_ref)
    monkeypatch.setattr(TA, "_xla_attention", spy_xla)
    b, nh = 1, 2
    q, k, v = _np((b, s, nh, hd), 18), _np((b, s, nkv, hd), 19), _np((b, s, nkv, hd), 20)
    mask = np.ones((b, s), np.float32)
    mask[0, -40:] = 0
    bias = (1.0 - mask)[:, None, None, :] * -1e9 if bias_kind else None
    bias_type = "key_padding" if bias_kind == "key_padding" else "additive"
    launches = TF.flash_attention_fwd.launches
    got = TA.core_attention(_t(q), _t(k), _t(v), causal=True,
                            bias=None if bias is None else _t(bias), impl=impl,
                            bias_type=bias_type)
    assert calls == [route], name
    assert TF.flash_attention_fwd.launches == launches  # the CPU never launches
    want = JA.core_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                             bias=None if bias is None else jnp.asarray(bias), impl="xla")
    valid = mask[0] > 0
    np.testing.assert_allclose(got.numpy()[:, valid], np.asarray(want)[:, valid],
                               atol=_ATOL_FLASH)


def test_core_attention_refuses_cross_shaped_key_padding():
    q = torch.zeros(1, 128, 2, 128)
    k = torch.zeros(1, 256, 2, 128)
    with pytest.raises(ValueError, match="SELF-attention"):
        TA.core_attention(q, k, k, bias=torch.zeros(1, 1, 1, 256), bias_type="key_padding")
