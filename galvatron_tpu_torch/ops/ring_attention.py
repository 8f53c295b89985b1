"""Ring attention (context parallelism) on the flash-attention kernels.

Port of ``galvatron_tpu/ops/ring_attention.py``. The cp ranks of a layer
each hold a shard of the sequence; K/V (with their key segment ids) rotate
around the ring, one hop per step, and each rank folds every visiting
block into a running fp32 ``(out, lse)``. The reference computes each step
as a ``jnp`` online softmax over key chunks with a mask from global
positions; the port runs each step on the hand-written kernels of
``ops/flash_attention.py`` (``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu``), on the blocks the step's (query chunk, key
chunk) pairs leave visible, which it derives from the layout's chunk
indices (`ring_blocks`):

- ``zigzag`` (rank r holds chunks r and 2cp-1-r of 2cp): step 0 is one
  causal call on the local 2c x 2c block; K/V from a lower rank are one
  non-causal call of every query against their first chunk (2c x c); K/V
  from a higher rank one non-causal call of the second query chunk against
  both (c x 2c). Every step does the same work on every rank.
- ``ring`` (rank r holds chunk r of cp): the diagonal step is one causal
  call, a lower rank's K/V one full call, a higher rank's nothing.

The merge keeps the running state in fp32: each block's output (in the
input dtype) is cast up before it is rescaled by ``exp(lse_blk - lse)``.
The kernels add ``DEFAULT_MASK_VALUE`` to masked logits, so a row that sees
no key of a block gets a finite, hugely negative ``lse_blk`` and weight 0;
step 0 always holds the diagonal, so the running ``lse`` is finite after
it and ``exp(-inf - (-inf))`` never forms.

The backward (`RingAttention.backward`, the reference's ``_ring_backward``)
calls the backward kernel on the same blocks with the MERGED ``out`` and
``lse`` sliced to the block's rows, so the kernel's ``di = rowsum(out *
dout)`` and ``p = exp(s - lse)`` are the global ones; dq accumulates in
fp32, and the fp32 dk/dv accumulators rotate with K/V, so after the full
cycle each lands on the rank that owns its block.

A transport moves the blocks: `P2PRing` (one cp rank per process,
``batch_isend_irecv`` on the layer's cp group: the training path) or
`LocalRing` (every cp rank's shards in one process: the CPU op tests and
the single-card check of ``chip_smoke.py``). Inputs and outputs are lists
with one entry per rank the process hosts. `ring_attention_reference` and
`ring_attention_reference_bwd` are the plain version: the reference's
blockwise online softmax over key chunks, masked from global positions,
and its hand-written backward from the forward's ``(out, lse)`` with the
backward kernel's roundings (in bf16 those roundings matter: autograd of
the unrounded plain forward is farther from the kernels on the rows whose
dq cancels, those that see a few keys).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from galvatron_tpu_torch.ops.flash_attention import (
    DEFAULT_MASK_VALUE,
    SegmentIds,
    flash_attention_bwd,
    flash_attention_fwd,
)

CP_MODES = ("ring", "zigzag")


# ------------------------------------------------------------------ layouts
def zigzag_permutation(seq_len: int, cp: int) -> np.ndarray:
    """Global sequence permutation placing chunks (i, 2cp-1-i) on shard i
    (the reference's): returns idx such that ``x_zigzag = x[idx]``."""
    if seq_len % (2 * cp):
        raise ValueError("seq_len=%d must divide into 2*cp=%d chunks" % (seq_len, 2 * cp))
    chunk = seq_len // (2 * cp)
    order = []
    for r in range(cp):
        order += [r, 2 * cp - 1 - r]
    return np.concatenate([np.arange(c * chunk, (c + 1) * chunk) for c in order])


def inverse_permutation(idx: np.ndarray) -> np.ndarray:
    inv = np.empty_like(idx)
    inv[idx] = np.arange(len(idx))
    return inv


def chunk_positions(mode: str, cp: int, rank: int, seq_len: int) -> np.ndarray:
    """The global positions rank `rank` of `cp` holds, in order."""
    if mode == "zigzag":
        return zigzag_permutation(seq_len, cp).reshape(cp, -1)[rank]
    return np.arange(seq_len).reshape(cp, -1)[rank]


class Block(NamedTuple):
    """One flash call of a ring step: query rows `q`, key rows `kv` of the
    visiting block, causal (diagonal) or not."""

    q: slice
    kv: slice
    causal: bool


def ring_blocks(mode: str, rank: int, src: int, s_local: int, causal: bool = True) -> List[Block]:
    """The calls of the step in which `rank` holds the K/V of rank `src`
    (each rank holds `s_local` tokens)."""
    full = slice(0, s_local)
    if not causal:
        return [Block(full, full, False)]
    if src == rank:
        return [Block(full, full, True)]
    if mode == "ring":
        return [Block(full, full, False)] if src < rank else []
    c = s_local // 2
    if src < rank:
        return [Block(full, slice(0, c), False)]
    return [Block(slice(c, s_local), full, False)]


# --------------------------------------------------------------- transports
class RingTransport:
    """Moves each hosted rank's tensors to the next rank of the ring.
    `ranks` are the ring positions this process hosts."""

    size: int
    ranks: Tuple[int, ...]

    def rotate(self, tensors: Dict[int, List[torch.Tensor]]) -> Dict[int, List[torch.Tensor]]:
        """Rank r's list goes to rank r+1 (mod size); returns what each
        hosted rank received, from rank r-1."""
        raise NotImplementedError


class LocalRing(RingTransport):
    """Every rank of a ring of `size` in this process; a hop is a clone,
    so aliasing cannot hide a bug."""

    def __init__(self, size: int):
        self.size = size
        self.ranks = tuple(range(size))

    def rotate(self, tensors):
        return {(r + 1) % self.size: [t.clone() for t in ts] for r, ts in tensors.items()}


class P2PRing(RingTransport):
    """This process is one rank of the ring over `group` (a
    ``torch.distributed`` group whose group ranks are the ring positions):
    a hop is one ``batch_isend_irecv`` (the sends to the next rank and the
    receives from the previous one in one batch)."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        me = dist.get_group_rank(group, dist.get_rank())
        self.ranks = (me,)
        self.next = dist.get_global_rank(group, (me + 1) % self.size)
        self.prev = dist.get_global_rank(group, (me - 1) % self.size)

    def rotate(self, tensors):
        import torch.distributed as dist

        (me, ts), = tensors.items()
        ops, out = [], []
        for t in ts:
            t = t.contiguous()
            buf = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, self.next, self.group))
            ops.append(dist.P2POp(dist.irecv, buf, self.prev, self.group))
            out.append(buf)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return {me: out}


# ----------------------------------------------------------- the ring passes
def _seg(q_seg, kv_seg, blk: Block) -> Optional[SegmentIds]:
    if q_seg is None:
        return None
    return SegmentIds(q_seg[:, blk.q].contiguous(), kv_seg[:, blk.kv].contiguous())


def _merge(acc_out: torch.Tensor, acc_lse: torch.Tensor, rows: slice, out: torch.Tensor,
           lse: torch.Tensor) -> None:
    """Fold one block's (out (B, s, H, D), lse (B, H, s)) into the fp32
    running state's `rows`, in place."""
    old = acc_lse[:, :, rows]
    m = torch.maximum(old, lse)  # finite: the block's lse is
    w_old, w_new = torch.exp(old - m), torch.exp(lse - m)
    total = w_old + w_new
    acc_lse[:, :, rows] = m + torch.log(total)
    w_old, w_new = ((w / total).transpose(1, 2)[..., None] for w in (w_old, w_new))
    acc_out[:, rows] = acc_out[:, rows] * w_old + out.float() * w_new


def ring_forward(qs, ks, vs, q_segs, kv_segs, *, transport: RingTransport, mode: str,
                 causal: bool, sm_scale: float):
    """Per hosted rank, (out in q's dtype, lse fp32 (B, H, s)) of its query
    shard against every rank's K/V."""
    n = transport.size
    acc = {}
    for r in transport.ranks:
        b, s, h, d = qs[r].shape
        acc[r] = (torch.zeros((b, s, h, d), dtype=torch.float32, device=qs[r].device),
                  torch.full((b, h, s), -float("inf"), dtype=torch.float32, device=qs[r].device))
    cur = {r: [ks[r], vs[r]] + ([kv_segs[r]] if kv_segs is not None else [])
           for r in transport.ranks}
    for step in range(n):
        for r in transport.ranks:
            k, v = cur[r][0], cur[r][1]
            kseg = cur[r][2] if kv_segs is not None else None
            qseg = q_segs[r] if q_segs is not None else None
            for blk in ring_blocks(mode, r, (r - step) % n, qs[r].shape[1], causal):
                out, lse = flash_attention_fwd(
                    qs[r][:, blk.q], k[:, blk.kv], v[:, blk.kv], causal=blk.causal,
                    sm_scale=sm_scale, segment_ids=_seg(qseg, kseg, blk))
                _merge(acc[r][0], acc[r][1], blk.q, out, lse)
        if step < n - 1:
            cur = transport.rotate(cur)
    return {r: (acc[r][0].to(qs[r].dtype), acc[r][1]) for r in transport.ranks}


def ring_backward(qs, ks, vs, outs, lses, douts, q_segs, kv_segs, *,
                  transport: RingTransport, mode: str, causal: bool, sm_scale: float):
    """Per hosted rank, (dq, dk, dv) in the input dtype."""
    n = transport.size
    dq = {r: torch.zeros(qs[r].shape, dtype=torch.float32, device=qs[r].device)
          for r in transport.ranks}
    cur = {r: [ks[r], vs[r]] + ([kv_segs[r]] if kv_segs is not None else [])
           for r in transport.ranks}
    grads = {r: [torch.zeros(ks[r].shape, dtype=torch.float32, device=ks[r].device)
                 for _ in range(2)] for r in transport.ranks}
    for step in range(n):
        for r in transport.ranks:
            k, v = cur[r][0], cur[r][1]
            kseg = cur[r][2] if kv_segs is not None else None
            qseg = q_segs[r] if q_segs is not None else None
            do = douts[r] if douts[r].stride(-1) == 1 else douts[r].contiguous()
            for blk in ring_blocks(mode, r, (r - step) % n, qs[r].shape[1], causal):
                g_q, g_k, g_v = flash_attention_bwd(
                    qs[r][:, blk.q], k[:, blk.kv], v[:, blk.kv], outs[r][:, blk.q],
                    lses[r][:, :, blk.q].contiguous(), do[:, blk.q], causal=blk.causal,
                    sm_scale=sm_scale, segment_ids=_seg(qseg, kseg, blk))
                dq[r][:, blk.q] += g_q.float()
                grads[r][0][:, blk.kv] += g_k.float()
                grads[r][1][:, blk.kv] += g_v.float()
        # the accumulators travel with their K/V block: after n hops each
        # is back on its owner (the K/V themselves are dead after the last step)
        if step < n - 1:
            moved = transport.rotate({r: cur[r] + grads[r] for r in transport.ranks})
            cur = {r: ts[:-2] for r, ts in moved.items()}
            grads = {r: ts[-2:] for r, ts in moved.items()}
        else:
            grads = transport.rotate(grads)
    return {r: (dq[r].to(qs[r].dtype), grads[r][0].to(ks[r].dtype), grads[r][1].to(vs[r].dtype))
            for r in transport.ranks}


class RingAttention(torch.autograd.Function):
    """The ring with the kernels on both passes (the reference's
    ``jax.custom_vjp`` ring): ``apply(config, *q, *k, *v, *q_seg, *kv_seg)``
    with one tensor per hosted rank in each group (the segment groups
    empty without padding); returns the hosted ranks' outputs."""

    @staticmethod
    def forward(ctx, config, *tensors):
        transport, mode, causal, sm_scale, has_seg = config
        ranks = transport.ranks
        n = len(ranks)
        groups = [dict(zip(ranks, tensors[i * n:(i + 1) * n])) for i in range(len(tensors) // n)]
        qs, ks, vs = groups[:3]
        q_segs, kv_segs = (groups[3], groups[4]) if has_seg else (None, None)
        res = ring_forward(qs, ks, vs, q_segs, kv_segs, transport=transport, mode=mode,
                           causal=causal, sm_scale=sm_scale)
        outs = [res[r][0] for r in ranks]
        ctx.config = config
        ctx.save_for_backward(*tensors, *outs, *[res[r][1] for r in ranks])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        transport, mode, causal, sm_scale, has_seg = ctx.config
        ranks = transport.ranks
        n = len(ranks)
        saved = ctx.saved_tensors
        groups = [dict(zip(ranks, saved[i * n:(i + 1) * n])) for i in range(len(saved) // n)]
        qs, ks, vs = groups[:3]
        q_segs, kv_segs = (groups[3], groups[4]) if has_seg else (None, None)
        outs, lses = groups[-2:]
        grads = ring_backward(qs, ks, vs, outs, lses, dict(zip(ranks, douts)), q_segs, kv_segs,
                              transport=transport, mode=mode, causal=causal, sm_scale=sm_scale)
        out = [None]
        for i in range(3):
            out += [grads[r][i] for r in ranks]
        return tuple(out + [None] * (2 * n if has_seg else 0))


def _expand_kv(q, k, v):
    if k.shape[2] == q.shape[2]:
        return k, v
    from galvatron_tpu_torch.ops.attention import repeat_kv

    if q.shape[2] % k.shape[2]:
        raise ValueError("q heads (%d) must be a multiple of kv heads (%d)"
                         % (q.shape[2], k.shape[2]))
    n_rep = q.shape[2] // k.shape[2]
    return repeat_kv(k, n_rep), repeat_kv(v, n_rep)


def ring_attention(q, k, v, *, transport: RingTransport, mode: str = "zigzag",
                   causal: bool = True, sm_scale: Optional[float] = None,
                   q_segment_ids=None, kv_segment_ids=None):
    """Ring attention over `transport`'s ring. q/k/v are BSNH shards (kv
    may have fewer heads: GQA is expanded before the ring), each a tensor
    for a process that hosts one rank or a list with one per hosted rank
    (`LocalRing`); segment ids (B, s) int32 key-padding ids of the same
    shards, or None. Returns the output in the same form."""
    if mode not in CP_MODES:
        raise ValueError("cp_mode must be one of %s, got %r" % (CP_MODES, mode))
    single = isinstance(q, torch.Tensor)
    qs, ks, vs = ([t] if single else list(t) for t in (q, k, v))
    if len(qs) != len(transport.ranks):
        raise ValueError("%d query shards for a transport hosting ranks %s"
                         % (len(qs), transport.ranks))
    kvs = [_expand_kv(a, b, c) for a, b, c in zip(qs, ks, vs)]
    ks, vs = [kv[0] for kv in kvs], [kv[1] for kv in kvs]
    if sm_scale is None:
        sm_scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    has_seg = q_segment_ids is not None
    segs = []
    if has_seg:
        segs = ([q_segment_ids] if single else list(q_segment_ids)) + \
               ([kv_segment_ids] if single else list(kv_segment_ids))
        segs = [t.to(torch.int32).contiguous() for t in segs]
    outs = RingAttention.apply((transport, mode, causal, float(sm_scale), has_seg),
                               *qs, *ks, *vs, *segs)
    return outs[0] if single else list(outs)


# ------------------------------------------------------------ plain version
def _plain_logits(q, k, q_pos, k_pos, q_seg, k_seg, causal, sm_scale):
    """(B, H, s, c) fp32 logits of (B, H, s, D) q against (B, H, c, D) k,
    DEFAULT_MASK_VALUE added where the key is later than the query (by
    global position) or of another segment, as the kernels add it."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    mask = torch.ones(logits.shape[-2:], dtype=torch.bool, device=q.device)[None, None]
    if causal:
        mask = mask & (q_pos[:, None, :, None] >= k_pos[:, None, None, :])
    if q_seg is not None:
        mask = mask & (q_seg[:, None, :, None] == k_seg[:, None, None, :])
    return logits + torch.where(mask, 0.0, DEFAULT_MASK_VALUE)


def _plain_args(qs, ks, vs, sm_scale):
    ks, vs = map(list, zip(*[_expand_kv(q, k, v) for q, k, v in zip(qs, ks, vs)]))
    if sm_scale is None:
        sm_scale = 1.0 / (qs[0].shape[-1] ** 0.5)
    return ks, vs, sm_scale


def ring_attention_reference(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                             vs: Sequence[torch.Tensor], positions: Sequence[torch.Tensor], *,
                             causal: bool = True, sm_scale: Optional[float] = None,
                             segment_ids: Optional[Sequence[torch.Tensor]] = None,
                             key_chunk: int = 512):
    """The reference's ring forward in plain PyTorch on every rank's shards
    (one list entry per cp rank): each rank's queries against every rank's
    K/V, in ring order, as an online softmax over `key_chunk`-key chunks in
    fp32 (peak logits (B, H, s, key_chunk)), masked from the global
    `positions` ((B, s) per rank) and, with `segment_ids`, to keys of the
    query's own segment. Returns per rank (out in q's dtype, lse (B, H, s)
    fp32)."""
    ks, vs, sm_scale = _plain_args(qs, ks, vs, sm_scale)
    seg = segment_ids if segment_ids is not None else [None] * len(qs)
    outs, lses = [], []
    for r in range(len(qs)):
        q = qs[r].float().transpose(1, 2)  # (B, H, s, D)
        b, h, s, d = q.shape
        acc = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
        row_max = torch.full((b, h, s), -float("inf"), dtype=torch.float32, device=q.device)
        row_sum = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
        for step in range(len(qs)):
            src = (r - step) % len(qs)
            k_all, v_all = ks[src].float().transpose(1, 2), vs[src].float().transpose(1, 2)
            for c0 in range(0, k_all.shape[2], key_chunk):
                cs = slice(c0, c0 + key_chunk)
                logits = _plain_logits(q, k_all[:, :, cs], positions[r], positions[src][:, cs],
                                       seg[r], None if seg[src] is None else seg[src][:, cs],
                                       causal, sm_scale)
                new_max = torch.maximum(row_max, logits.amax(-1))
                corr = torch.exp(row_max - new_max)
                probs = torch.exp(logits - new_max[..., None])
                row_sum = row_sum * corr + probs.sum(-1)
                acc = acc * corr[..., None] + probs @ v_all[:, :, cs]
                row_max = new_max
        outs.append((acc / row_sum[..., None]).transpose(1, 2).to(qs[r].dtype))
        lses.append(row_max + torch.log(row_sum))
    return outs, lses


def ring_attention_reference_bwd(qs, ks, vs, outs, lses, douts,
                                 positions: Sequence[torch.Tensor], *, causal: bool = True,
                                 sm_scale: Optional[float] = None,
                                 segment_ids: Optional[Sequence[torch.Tensor]] = None,
                                 key_chunk: int = 512):
    """The reference's ring backward in plain PyTorch (its hand-written VJP:
    probabilities recomputed per key chunk from `lses`), from every rank's
    shards, the forward's outputs and logsumexps (`ring_attention_reference`'s
    or the ring's) and the cotangents, with the backward
    kernel's roundings (p to the cotangent's dtype before dv, ds to the
    input dtype before dq and dk; fp32 products and sums). Returns per rank
    (dq, dk, dv) in the input dtypes (GQA: dk/dv of the expanded heads
    summed back onto the kv heads)."""
    n = len(qs)
    kvh = ks[0].shape[2]
    ks, vs, sm_scale = _plain_args(qs, ks, vs, sm_scale)
    seg = segment_ids if segment_ids is not None else [None] * n
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device).transpose(1, 2)
           for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device).transpose(1, 2)
           for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device).transpose(1, 2)
           for v in vs]
    for r in range(n):
        q = qs[r].float().transpose(1, 2)
        do = douts[r].float().transpose(1, 2)
        di = (outs[r].float().transpose(1, 2) * do).sum(-1)  # (B, H, s)
        for src in range(n):
            k_all, v_all = ks[src].float().transpose(1, 2), vs[src].float().transpose(1, 2)
            for c0 in range(0, k_all.shape[2], key_chunk):
                cs = slice(c0, c0 + key_chunk)
                logits = _plain_logits(q, k_all[:, :, cs], positions[r], positions[src][:, cs],
                                       seg[r], None if seg[src] is None else seg[src][:, cs],
                                       causal, sm_scale)
                p = torch.exp(logits - lses[r][..., None])
                dvs[src][:, :, cs] += p.to(douts[r].dtype).float().transpose(2, 3) @ do
                dp = do @ v_all[:, :, cs].transpose(2, 3)
                ds = ((dp - di[..., None]) * p * sm_scale).to(qs[r].dtype).float()
                dqs[r] += ds @ k_all[:, :, cs]
                dks[src][:, :, cs] += ds.transpose(2, 3) @ q
    out = []
    for r in range(n):
        dk, dv = (t.transpose(1, 2) for t in (dks[r], dvs[r]))
        if dk.shape[2] != kvh:  # GQA: sum the expanded heads' gradients
            dk, dv = (t.unflatten(2, (kvh, -1)).sum(3) for t in (dk, dv))
        out.append((dqs[r].transpose(1, 2).to(qs[r].dtype), dk.to(qs[r].dtype),
                    dv.to(qs[r].dtype)))
    return out
