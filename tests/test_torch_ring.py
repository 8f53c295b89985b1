"""The port's ring attention (``galvatron_tpu_torch/ops/ring_attention.py``)
on the CPU, every cp rank in one process (``LocalRing``), each ring step on
the flash kernels' plain versions:

- against the JAX package's ``ring_attention`` on the virtual CPU devices
  of ``tests/conftest.py``: cp 2 and 4, zigzag and ring, causal, with and
  without a key-padding tail, MHA and GQA; the output on valid rows and
  dq/dk/dv (the cotangent zero on padded rows) in fp32, each element
  within TOL_ABS + TOL_REL * max|ref| (the reference's own ring tests
  hold 2e-5 and 3e-5);
- against its own plain version (``ring_attention_reference``, the
  reference's blockwise online softmax masked from global positions, and
  ``ring_attention_reference_bwd``, its hand-written backward): in fp32
  the backward fed the plain forward's output and logsumexp, within the
  same limit; in bf16, as ``chip_smoke.py`` phase 13 checks it, within
  the card's row-scaled limits, the backward fed the ring's merged output
  and logsumexp and those held against the plain forward's;
- the layouts: ``zigzag_permutation`` equal to the reference's, the
  blocks of every ring step covering exactly the causal pairs once, and
  the chunk order that turns a wider zigzag into a layer's own
  (``models.base.zigzag_local_order``).

The divergence of the reference's zigzag batches at mixed cp, and the
port's fix, are shown in ``tests/test_torch_parallel.py`` (a world of 2
ranks: ``test_zigzag_divergence_of_the_reference_and_the_ports_fix``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from galvatron_tpu.ops import ring_attention as JR
from galvatron_tpu.parallel.mesh import LayerAxes as JLayerAxes
from galvatron_tpu_torch.models.base import zigzag_local_order
from galvatron_tpu_torch.ops import ring_attention as TR

B, S, NH, HD = 2, 64, 4, 16
PAD = (13, 5)  # padded tail per row
TOL_ABS, TOL_REL = 2e-5, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch's thread pool beside JAX's initialised CPU backend runs small
    ops many times slower (see tests/test_torch_profile.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, nkv=NH, padded=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, NH, HD).astype(np.float32)
    k, v = (rng.randn(B, S, nkv, HD).astype(np.float32) for _ in range(2))
    do = rng.randn(B, S, NH, HD).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    if padded:
        for row, pad in enumerate(PAD):
            mask[row, -pad:] = 0.0
    do = do * mask[:, :, None, None]  # padded queries' outputs are not used
    return q, k, v, do, mask


def _perm(mode, cp):
    return JR.zigzag_permutation(S, cp) if mode == "zigzag" else np.arange(S)


def _jax_ring(q, k, v, do, mask, mode, cp, padded, devices):
    """The JAX package's ring over `cp` devices on the permuted sequence:
    (out, dq, dk, dv), permuted."""
    idx = _perm(mode, cp)
    mesh = Mesh(np.array(devices[:cp]).reshape(1, cp), ("m0", "m1"))
    axes = JLayerAxes(dp=(), cp=("m1",), tp=())

    def put(x, spec):
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    qkv = P(None, "m1", None, None)
    pos = put(np.broadcast_to(np.arange(S), (B, S))[:, idx], P(None, "m1"))
    bias = None
    if padded:
        bias = put(((1.0 - mask) * -1e9)[:, idx][:, None, None, :], P(None, None, None, "m1"))

    def f(q_, k_, v_):
        return JR.ring_attention(q_, k_, v_, pos, mesh=mesh, axes=axes, causal=True, bias=bias)

    @jax.jit
    def out_and_grads(q_, k_, v_, do_):
        out, vjp = jax.vjp(f, q_, k_, v_)
        return (out,) + tuple(vjp(do_))

    return [np.asarray(t) for t in out_and_grads(*[put(t[:, idx], qkv) for t in (q, k, v, do)])]


def _port_ring(q, k, v, do, mask, mode, cp, padded):
    """The port's ring through LocalRing: (out, dq, dk, dv), permuted."""
    idx = _perm(mode, cp)

    def shards(t, grad=False):
        parts = torch.from_numpy(np.ascontiguousarray(t[:, idx])).chunk(cp, 1)
        return [p.clone().requires_grad_(grad) for p in parts]

    qs, ks, vs = (shards(t, True) for t in (q, k, v))
    seg = shards(mask.astype(np.int32)) if padded else None
    outs = TR.ring_attention(qs, ks, vs, transport=TR.LocalRing(cp), mode=mode,
                             q_segment_ids=seg, kv_segment_ids=seg)
    torch.autograd.backward(outs, shards(do))
    cat = lambda ts: torch.cat([t.detach() for t in ts], 1).numpy()  # noqa: E731
    return [cat(outs), cat([t.grad for t in qs]), cat([t.grad for t in ks]),
            cat([t.grad for t in vs])]


def _check(got, want, what, rows=None):
    if rows is not None:
        got, want = got[rows], want[rows]
    err = np.abs(got - want).max()
    limit = TOL_ABS + TOL_REL * np.abs(want).max()
    assert err <= limit, "%s: max err %.3g > %.3g" % (what, err, limit)


RING_CASES = [(mode, cp, padded, nkv) for mode in ("zigzag", "ring") for cp in (2, 4)
              for padded in (False, True) for nkv in (NH, 2)]


@pytest.mark.parametrize("mode,cp,padded,nkv", RING_CASES,
                         ids=["%s-cp%d-%s-kv%d" % (m, c, "pad" if p else "full", n)
                              for m, c, p, n in RING_CASES])
def test_ring_matches_the_jax_ring(mode, cp, padded, nkv, devices8):
    q, k, v, do, mask = _inputs(cp * 10 + nkv, nkv, padded)
    want = _jax_ring(q, k, v, do, mask, mode, cp, padded, devices8)
    got = _port_ring(q, k, v, do, mask, mode, cp, padded)
    valid = mask[:, _perm(mode, cp)] > 0
    _check(got[0], want[0], "out", valid)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        _check(g, w, name)


@pytest.mark.parametrize("mode,cp,padded", [(m, c, p) for m in ("zigzag", "ring")
                                            for c in (2, 4) for p in (False, True)])
def test_ring_matches_its_plain_version(mode, cp, padded):
    """The output and merged logsumexp against the plain forward; dq/dk/dv
    against the plain backward fed the plain forward's own output and
    logsumexp."""
    q, k, v, do, mask = _inputs(cp + 7, 2, padded)
    got = _port_ring(q, k, v, do, mask, mode, cp, padded)
    idx = _perm(mode, cp)

    def shards(t):
        return list(torch.from_numpy(np.ascontiguousarray(t[:, idx])).chunk(cp, 1))

    qs, ks, vs, dos = (shards(t) for t in (q, k, v, do))
    positions = [torch.from_numpy(TR.chunk_positions(mode, cp, r, S)).expand(B, -1)
                 for r in range(cp)]
    seg = shards(mask.astype(np.int32)) if padded else None
    outs, lses = TR.ring_attention_reference(qs, ks, vs, positions, segment_ids=seg,
                                             key_chunk=8)
    grads = TR.ring_attention_reference_bwd(qs, ks, vs, outs, lses, dos, positions,
                                            segment_ids=seg, key_chunk=8)
    # the ring's merged logsumexp (the autograd wrapper keeps it for its
    # backward and returns the output only)
    expanded = [TR._expand_kv(a, b, c) for a, b, c in zip(qs, ks, vs)]
    merged = TR.ring_forward(dict(enumerate(qs)), {r: kv[0] for r, kv in enumerate(expanded)},
                             {r: kv[1] for r, kv in enumerate(expanded)},
                             dict(enumerate(seg)) if padded else None,
                             dict(enumerate(seg)) if padded else None,
                             transport=TR.LocalRing(cp), mode=mode, causal=True,
                             sm_scale=HD ** -0.5)
    valid = mask[:, idx] > 0
    _check(got[0], torch.cat(outs, 1).numpy(), "out", valid)
    _check(torch.cat([merged[r][1] for r in range(cp)], 2).numpy().transpose(0, 2, 1),
           torch.cat(lses, 2).numpy().transpose(0, 2, 1), "lse", valid)
    for i, name in enumerate(("dq", "dk", "dv")):
        _check(got[1 + i], torch.cat([g[i] for g in grads], 1).numpy(), name)


@pytest.mark.parametrize("mode,cp,padded", [(m, c, p) for m in ("zigzag", "ring")
                                            for c in (2, 4) for p in (False, True)])
def test_bf16_ring_holds_the_cards_check_against_its_plain_version(mode, cp, padded):
    """``chip_smoke.py`` phase 13's check of the ring against the plain
    ring, at a small size: bf16, head_dim 128, the cotangent zero on padded
    queries; the output on every row and dq/dk/dv on the valid rows within
    the card's row-scaled bf16 limits (``chip_smoke.judge``), the merged
    logsumexp on the valid rows within its TOL_LSE. The plain backward
    rounds p and ds as the kernels do; it is fed what the ring's kernels
    took, the merged output and logsumexp, which are held against the
    plain forward's."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    s, nh, hd = 512, 2, 128
    gen = torch.Generator().manual_seed(cp * 100 + padded)
    q, k, v, do = (torch.randn((1, s, nh, hd), generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    valid = s - s // 8 - 3 if padded else s
    do[:, valid:] = 0
    ids = (torch.arange(s) < valid).to(torch.int32)[None].contiguous()
    idx = torch.as_tensor(TR.zigzag_permutation(s, cp) if mode == "zigzag" else np.arange(s))
    inv = torch.as_tensor(TR.inverse_permutation(idx.numpy()))

    def shards(t):
        return [x.contiguous() for x in t[:, idx].chunk(cp, 1)]

    def natural(parts, dim=1):
        return torch.cat(list(parts), dim).index_select(dim, inv)

    qs, ks, vs, dos = (shards(t) for t in (q, k, v, do))
    segs = shards(ids) if padded else None
    kw = dict(transport=TR.LocalRing(cp), mode=mode, causal=True, sm_scale=hd ** -0.5)
    ring = lambda ts: dict(enumerate(ts)) if ts is not None else None  # noqa: E731
    res = TR.ring_forward(ring(qs), ring(ks), ring(vs), ring(segs), ring(segs), **kw)
    outs, lses = ({r: t[i] for r, t in res.items()} for i in range(2))
    grads = TR.ring_backward(ring(qs), ring(ks), ring(vs), outs, lses, ring(dos), ring(segs),
                             ring(segs), **kw)
    positions = [torch.as_tensor(TR.chunk_positions(mode, cp, r, s))[None] for r in range(cp)]
    pouts, plses = TR.ring_attention_reference(qs, ks, vs, positions, segment_ids=segs)
    pgrads = TR.ring_attention_reference_bwd(qs, ks, vs, [outs[r] for r in range(cp)],
                                             [lses[r] for r in range(cp)], dos, positions,
                                             segment_ids=segs)
    got = [natural(outs.values())] + [natural(g[i] for g in grads.values()) for i in range(3)]
    want = [natural(pouts)] + [natural(g[i] for g in pgrads) for i in range(3)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        rows = slice(None) if name == "out" else slice(0, valid)
        tol = CS.TOL_FWD_BF16 if name == "out" else CS.TOL_BWD_BF16
        n_bad, used, err, _ = CS.judge(torch, g[:, rows], w[:, rows], tol)
        assert n_bad == 0, "%s: %d elements over the limit (%.3g of it, err %.3g)" % (
            name, n_bad, used, err)
    lse_err = (natural(lses.values(), 2) - natural(plses, 2))[..., :valid].abs().max().item()
    assert lse_err <= CS.TOL_LSE, lse_err


@pytest.mark.parametrize("s,cp", [(32, 2), (64, 4), (48, 3), (256, 8)])
def test_zigzag_permutation_matches_the_reference(s, cp):
    np.testing.assert_array_equal(TR.zigzag_permutation(s, cp), JR.zigzag_permutation(s, cp))
    idx = TR.zigzag_permutation(s, cp)
    np.testing.assert_array_equal(TR.inverse_permutation(idx), JR.inverse_permutation(idx))
    for r in range(cp):
        np.testing.assert_array_equal(TR.chunk_positions("zigzag", cp, r, s),
                                      idx.reshape(cp, -1)[r])


@pytest.mark.parametrize("mode,cp", [(m, c) for m in ("zigzag", "ring") for c in (1, 2, 4, 8)])
def test_ring_blocks_cover_every_causal_pair_once(mode, cp):
    """Over the ring's steps, each rank's blocks (causal diagonals by
    index) admit exactly the (query, key) pairs with key position <= query
    position, each once; under zigzag every rank makes one call per step
    (cp calls per rank, cp * cp in a cp-rank ring's forward), under ring
    rank r makes r + 1."""
    s = 16 * cp
    calls = 0
    for r in range(cp):
        qpos = TR.chunk_positions(mode, cp, r, s)
        seen = np.zeros((s // cp, s), np.int64)
        for step in range(cp):
            src = (r - step) % cp
            kpos = TR.chunk_positions(mode, cp, src, s)
            blocks = TR.ring_blocks(mode, r, src, s // cp)
            calls += len(blocks)
            if mode == "zigzag":
                assert len(blocks) == 1
            for blk in blocks:
                qi = np.arange(s // cp)[blk.q]
                ki = np.arange(s // cp)[blk.kv]
                ok = np.ones((len(qi), len(ki)), bool)
                if blk.causal:
                    ok = ki[None, :] <= qi[:, None]
                seen[np.ix_(qi, kpos[ki])] += ok
        np.testing.assert_array_equal(seen, (np.arange(s)[None, :] <= qpos[:, None]).astype(int))
    assert calls == (cp * cp if mode == "zigzag" else cp * (cp + 1) // 2)


@pytest.mark.parametrize("max_cp,cp", [(2, 1), (4, 1), (4, 2), (8, 2), (8, 4), (4, 4)])
def test_local_order_turns_a_wider_zigzag_into_the_layers_own(max_cp, cp):
    """A rank of a cp-rank layer holds 2 * max_cp / cp chunks of the
    batch's max_cp zigzag; in `zigzag_local_order` they are the chunks of
    the layer's own zigzag (the natural order at cp 1)."""
    s = 8 * 2 * max_cp
    wide = TR.zigzag_permutation(s, max_cp)
    own = TR.zigzag_permutation(s, cp) if cp > 1 else np.arange(s)
    for r in range(cp):
        held = wide.reshape(cp, -1)[r]
        order = zigzag_local_order(2 * max_cp // cp)
        chunks = np.split(held, len(order))
        np.testing.assert_array_equal(np.concatenate([chunks[i] for i in order]),
                                      own.reshape(cp, -1)[r])
