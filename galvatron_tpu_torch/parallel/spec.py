"""Placement builders: per-layer parameter and activation shardings.

Port of ``galvatron_tpu/parallel/spec.py``. A placement is the port's
``PartitionSpec``: one tuple of sub-axis names per tensor dim, ``()`` for a
dim that is not sharded, ``("m0", "m1")`` for a dim sharded over both
(``m0`` major). The builders are the reference's, entry for entry:

- a column-parallel kernel ``(in, out)`` is ``(z3, tp)`` and a row-parallel
  one ``(tp, z3)``: tp shards the heads / ffn dim, ZeRO-3 shards the other
  large dim over the layer's dp axes;
- activations between layers are ``act_spec``: batch over dp, sequence over
  cp (+ tp under Megatron-SP), hidden dense;
- the embedding table is vocab-parallel over the vocab tp axes.

`relayout` is the counterpart of ``monotone_constrain``: where XLA inserts
the collectives for a sharding constraint, it routes every dim through the
per-dim meet of the two placements, so each step only drops trailing
sub-axes (an all-gather over them) or appends them (a local split by this
rank's coordinate) — `parallel.comm` gives both their gradients.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from galvatron_tpu_torch.parallel import comm
from galvatron_tpu_torch.parallel.mesh import LayerAxes, RankMesh

Axes = Tuple[str, ...]
Spec = Tuple[Axes, ...]
Entry = Union[None, str, Sequence[str]]


def _axes(e: Entry) -> Axes:
    if e is None:
        return ()
    if isinstance(e, str):
        return (e,)
    return tuple(e)


def spec(*entries: Entry) -> Spec:
    """A placement from PartitionSpec-style entries (None, a name, or a
    tuple of names per dim)."""
    return tuple(_axes(e) for e in entries)


def _pad(s: Spec, ndim: int) -> Spec:
    return tuple(s) + ((),) * (ndim - len(s))


# ----------------------------------------------------------------- activations
def act_spec(ax: LayerAxes, *, seq_dim: int = 1, ndim: int = 3) -> Spec:
    """(batch, seq, hidden) activation between layers: batch over dp,
    sequence over cp (+ tp under ulysses or megatron-sp)."""
    entries = [()] * ndim
    entries[0] = tuple(ax.batch_axes)
    entries[seq_dim] = tuple(ax.seq_axes)
    return tuple(entries)


def token_seq_axes(ax: LayerAxes) -> Axes:
    """The axes sharding the sequence of the tokens, positions and masks
    a layer reads: cp, plus the tp axes under Ulysses, where the vocab
    layers embed and score their own sequence shard (Megatron-SP gathers
    the sequence over tp before it computes)."""
    return tuple(ax.cp) + (tuple(ax.tp) if ax.ulysses else ())


def side_spec(ax: LayerAxes) -> Spec:
    """(batch, seq) side inputs of a transformer layer (positions,
    key-padding masks): batch over dp, sequence over cp, the sequence
    attention runs on (Ulysses and Megatron-SP gather it over tp first)."""
    return (tuple(ax.batch_axes), tuple(ax.cp))


def token_spec(ax: LayerAxes) -> Spec:
    """(batch, seq) inputs of the vocab layers (tokens, positions,
    labels, masks)."""
    return (tuple(ax.batch_axes), token_seq_axes(ax))


def logits_spec(ax: LayerAxes) -> Spec:
    """(batch, seq, vocab) logits: vocab over tp (the vocab-parallel head
    and loss); under vocab-SP (ulysses) the sequence stays tp-sharded and
    the vocab dense."""
    if ax.ulysses:
        return spec(ax.batch_axes, ax.seq_axes, None)
    return spec(ax.batch_axes, ax.cp, ax.tp)


# ------------------------------------------------------------------ parameters
def _zero3_axes(ax: LayerAxes) -> Axes:
    return tuple(ax.dp) if ax.zero3 else ()


def _tp(ax: LayerAxes) -> Axes:
    return () if ax.ulysses else tuple(ax.tp)


def col_kernel_spec(ax: LayerAxes) -> Spec:
    """Column-parallel kernel (in, out): out over tp, ZeRO-3 shards in."""
    return spec(_zero3_axes(ax), _tp(ax))


def row_kernel_spec(ax: LayerAxes) -> Spec:
    """Row-parallel kernel (in, out): in over tp, ZeRO-3 shards out."""
    return spec(_tp(ax), _zero3_axes(ax))


def col_bias_spec(ax: LayerAxes) -> Spec:
    return spec(_tp(ax))


def replicated_1d_spec(ax: LayerAxes) -> Spec:
    """Norm scales and biases, row-parallel biases: replicated over tp,
    ZeRO-3 shards them over dp."""
    return spec(_zero3_axes(ax))


def vocab_embed_spec(ax: LayerAxes) -> Spec:
    """(vocab, hidden) table, vocab-parallel over tp; ZeRO-3 shards hidden
    over dp (vocab-dense under vocab-SP, where ZeRO-3 shards the vocab)."""
    if ax.ulysses:
        return spec(_zero3_axes(ax), None)
    return spec(ax.tp, _zero3_axes(ax))


def replicated_spec(ndim: int) -> Spec:
    return ((),) * ndim


# ------------------------------------------------------------------- utilities
def meet_spec(a: Spec, b: Spec, ndim: int) -> Spec:
    """Per-dim longest common prefix of two placements: re-laying a -> meet
    -> b only drops or appends trailing sub-axes on each dim."""
    out = []
    for xa, xb in zip(_pad(a, ndim), _pad(b, ndim)):
        common = []
        for i in range(min(len(xa), len(xb))):
            if xa[i] != xb[i]:
                break
            common.append(xa[i])
        out.append(tuple(common))
    return tuple(out)


def _groups(mesh: RankMesh, axes: Axes):
    """The groups a collective over the dim shards of `axes` runs on, major
    first: one group where the axes are in grid order (its group ranks are
    the shard order), else one per axis (a dim on ``(cp, tp)`` with tp the
    grid's major axis: gather tp's shards, then cp's)."""
    if mesh.in_grid_order(axes):
        return [mesh.group_for(axes)]
    return [mesh.group_for((a,)) for a in axes]


def relayout(x: torch.Tensor, mesh: RankMesh, from_spec: Spec, to_spec: Spec) -> torch.Tensor:
    """Re-lay `x` (this rank's shard under `from_spec`) as its shard under
    `to_spec`: first every dim drops the sub-axes past the meet (all-gather,
    backward: the slice), then appends those of `to_spec` (a local split,
    backward: all-gather). Equal placements return `x` itself."""
    from_spec, to_spec = _pad(from_spec, x.dim()), _pad(to_spec, x.dim())
    if from_spec == to_spec:
        return x
    meet = meet_spec(from_spec, to_spec, x.dim())
    for d in range(x.dim()):
        extra = from_spec[d][len(meet[d]):]
        for group in reversed(_groups(mesh, extra) if extra else []):
            x = comm.gather_split_bwd(x, d, group)
    for d in range(x.dim()):
        extra = to_spec[d][len(meet[d]):]
        for group in _groups(mesh, extra) if extra else []:
            x = comm.split_gather_bwd(x, d, group)
    return x


def local_shape(shape: Sequence[int], s: Spec, mesh: RankMesh, what: str = "tensor"):
    """The shard shape of a `shape` tensor placed as `s`; the JAX package
    never pads a shard, so an uneven split raises."""
    out = []
    for d, (n, ax) in enumerate(zip(shape, _pad(s, len(shape)))):
        k = mesh.size(ax)
        if n % k:
            raise ValueError("%s: dim %d of size %d does not split over %s (%d ranks)"
                             % (what, d, n, ax, k))
        out.append(n // k)
    return tuple(out)


def shard_tensor(full: torch.Tensor, s: Spec, mesh: RankMesh) -> torch.Tensor:
    """This rank's shard of a full tensor placed as `s` (a view)."""
    local_shape(full.shape, s, mesh)
    out = full
    for d, ax in enumerate(_pad(s, full.dim())):
        if ax:
            out = out.chunk(mesh.size(ax), d)[mesh.shard_index(ax)]
    return out


def gather_tensor(local: torch.Tensor, s: Spec, mesh: RankMesh) -> torch.Tensor:
    """The full tensor from every rank's shard under `s` (no gradient)."""
    out = local.detach()
    for d, ax in enumerate(_pad(s, local.dim())):
        for group in reversed(_groups(mesh, ax) if ax else []):
            out = comm.all_gather(out, d, group)
    return out
