"""Megatron tensor parallelism, with and without sequence parallelism.

The reference derives these from the kernel specs (GSPMD partitions the
einsums); the port writes them. A column-parallel linear holds the output
columns of its tp rank (``(in, out/tp)``) and a row-parallel one the input
rows (``(in/tp, out)``); around them sit Megatron's f/g pairs:

- `enter_column`, before a column-parallel linear: f (identity forward,
  all-reduce of the input's gradient), or under Megatron-SP the all-gather
  of the sequence-sharded activation (reduce-scatter backward);
- `exit_row`, after a row-parallel linear: g (all-reduce of the partial
  sums, identity backward), or under Megatron-SP the reduce-scatter onto
  sequence shards (all-gather backward).

A layer with tp=1 skips both: the ops are the identity, and the layer runs
the same code as without a layout. `TPContext` also carries what attention
needs to know about its head shard: with GQA, ``kv_head`` is the one key /
value head this rank's query heads share when the kv heads are fewer than
the tp degree (the kv projection is then replicated over tp, the
reference's GLS007 case ``tp % num_kv_heads == 0``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from galvatron_tpu_torch.parallel import comm

SEQ_DIM = 1


@dataclass(frozen=True)
class TPContext:
    group: object
    size: int
    index: int
    sequence_parallel: bool = False
    kv_head: Optional[int] = None


def enter_column(x: torch.Tensor, tp: Optional[TPContext]) -> torch.Tensor:
    """The input of a column-parallel linear: full sequence, replicated
    over tp."""
    if tp is None or tp.size == 1:
        return x
    if tp.sequence_parallel:
        return comm.gather_rs_bwd(x, SEQ_DIM, tp.group)
    return comm.reduce_bwd(x, tp.group)


def exit_row(y: torch.Tensor, tp: Optional[TPContext]) -> torch.Tensor:
    """The output of a row-parallel linear: partial sums over tp ->
    replicated (or sequence-sharded under Megatron-SP)."""
    if tp is None or tp.size == 1:
        return y
    if tp.sequence_parallel:
        return comm.rs_gather_bwd(y, SEQ_DIM, tp.group)
    return comm.reduce_fwd(y, tp.group)


def seq_shard(x: torch.Tensor, tp: Optional[TPContext]) -> torch.Tensor:
    """This rank's sequence shard of a tensor that is the same on every tp
    rank and needs no gradient (positions under Megatron-SP)."""
    if tp is None or tp.size == 1 or not tp.sequence_parallel:
        return x
    return x.chunk(tp.size, SEQ_DIM)[tp.index]
