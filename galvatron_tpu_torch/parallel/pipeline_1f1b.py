"""The 1F1B (pipedream-flush) schedule, per stage.

Port of ``galvatron_tpu/parallel/pipeline_1f1b.py``. The reference runs
1F1B as one SPMD scan over a (T, pp) tick table, with every cross-stage
movement on one all-gather per tick; that costs two extra ticks and one
extra stash slot (``build_schedule``), embeds and runs the head on every
stage every tick, keeps the vocab state sharded over ``pp``, and
recomputes each stage in its backward because nothing autodiffs through the
scan. The port runs the textbook per-stage order instead
(`one_f_one_b_order`): stage ``s`` runs ``pp - s - 1`` warm-up forwards,
then alternates one forward and one backward, then drains the remaining
backwards, so at most ``pp - s`` micro-batches are in flight on it,
whatever ``chunks`` is. The embedding runs on the first stage only, the
head on the last; each in-flight micro-batch keeps its graph under the
strategy's per-layer remat (the same `StageRunner` as GPipe), so the
flash kernels launch as often as in the unpipelined run at the same
``chunks``.

A forward followed by the backward's receive, and a backward followed by
the next forward's receive, are one exchange each (`Step` ``X`` with a
send and a receive): the two neighbours post them as one batch, in the same
order on both sides.
"""

from __future__ import annotations

from typing import List

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.parallel.pipeline import Step


def validate_1f1b_config(hp: HybridParallelConfig) -> None:
    """The reference's 1F1B contract: uneven divisions and per-stage
    heterogeneous strategies are allowed, every stage needs a layer, ring
    cp needs stage-uniform strategies (``HybridParallelConfig.
    pipeline_engine_findings``, GLS010 in the lint), and the global batch
    splits into ``chunks``. Under that contract every cp rank of a stage
    runs the same ring steps in the same order every tick: the cp ring's
    point-to-point hops (on the layer's cp group) and the stage boundary's
    (on the default group) never cross."""
    if hp.pp <= 1:
        return
    div = hp.pp_division
    if any(n < 1 for n in div):
        raise ValueError("every pipeline stage needs >= 1 layer, got %s" % (div,))
    for _, refusal in hp.pipeline_engine_findings():
        raise ValueError(refusal)
    if hp.global_bsz % hp.chunks != 0:
        raise ValueError("global_bsz must divide into chunks")


def one_f_one_b_order(pp: int, chunks: int, stage: int) -> List[Step]:
    """Stage `stage`'s 1F1B schedule: warm-up forwards, one forward and one
    backward alternating, then the cool-down backwards."""
    first, last = stage == 0, stage == pp - 1
    warmup = min(pp - stage - 1, chunks)
    steady = chunks - warmup
    out: List[Step] = []
    for i in range(warmup):
        if not first:
            out.append(Step("X", recvs=(("fwd", i),)))
        out.append(Step("F", i))
        out.append(Step("X", sends=(("fwd", i),)))
    if steady and not first:
        out.append(Step("X", recvs=(("fwd", warmup),)))
    for k in range(steady):
        i = warmup + k
        out.append(Step("F", i))
        if not last:
            out.append(Step("X", sends=(("fwd", i),), recvs=(("bwd", k),)))
        out.append(Step("B", k))
        if not first:
            more = k < steady - 1
            out.append(Step("X", sends=(("bwd", k),),
                            recvs=(("fwd", i + 1),) if more else ()))
    for k in range(steady, chunks):
        if not last:
            out.append(Step("X", recvs=(("bwd", k),)))
        out.append(Step("B", k))
        if not first:
            out.append(Step("X", sends=(("bwd", k),)))
    return out
