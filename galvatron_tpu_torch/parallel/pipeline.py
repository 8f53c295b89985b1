"""Pipeline parallelism: the GPipe schedule, the stage runner and the
transport seam.

Port of ``galvatron_tpu/parallel/pipeline.py``. The reference runs the whole
pipeline as one SPMD program: layer parameters stacked over a ``pp`` mesh
axis, a scan over micro-batch ticks, ``jnp.roll`` as the stage shift and
autodiff through the scan. The port runs the reference's source design
instead: each stage holds its own layers (``models.base.stage_model``), the
first stage the embedding and the last the head (and, for a tied model, its
own copy of the table), and a `StageRunner` runs one micro-batch forward on
a stage and, later, its backward from the cotangent the next stage sends
(``torch.autograd.backward(out, grad)``). Each in-flight micro-batch keeps
its autograd graph under the strategy's per-layer remat, so the
``checkpoint`` flags of a searched strategy mean what the search costed.

A schedule is one list of `Step`s per stage: forwards ``F``, backwards
``B`` and exchanges ``X`` with the neighbouring stages (`gpipe_order`: every
forward, then every backward; the 1F1B order is in ``pipeline_1f1b``). Every
movement and reduction across stages goes through a `Transport`, the one
object that owns them:

- `P2PTransport`: one stage per process. An exchange is one
  ``torch.distributed.batch_isend_irecv`` with the neighbouring stage's rank
  that has the same within-stage coordinate (a send and a receive in
  opposite directions ride one batch, so NCCL cannot deadlock on them);
  the tied embedding's gradient is summed over the first and last stage's
  group, the gradient norm and the guard's verdict are reduced over the
  pp group and the loss is broadcast from the last stage. ``cli train``
  always uses it.
- `LocalTransport`: one process hosts every stage of a strategy whose
  stages hold one device each. It runs the stages' schedules round robin,
  each until it waits for a hand-off; hand-offs are clones, so aliasing
  cannot hide a bug. It is selected by name, never as a fallback: the
  single-GPU checks and the single-process tests use it.

Activations cross a stage boundary in the vocab layers' layout (where
``run_layers`` leaves them); the neighbour's rank with the same
within-stage coordinate holds the matching shard.

`validate_pipeline_config` is the reference's; `unstack_params` reads its
``stages`` trees (numpy leaves, `tools/from_jax.py`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from galvatron_tpu_torch.config.strategy import HybridParallelConfig


# ------------------------------------------------------------------ validation
def validate_pipeline_config(hp: HybridParallelConfig) -> None:
    """The reference's GPipe contract: equal layers per stage, within-stage
    layer strategies uniform across stages, no cp
    (``HybridParallelConfig.pipeline_engine_findings``, whose diagnostics
    the lint reports as GLS010 / GLS011), and a global batch that splits
    into ``chunks``."""
    if hp.pp <= 1:
        return
    for _, refusal in hp.pipeline_engine_findings():
        raise ValueError(refusal)
    if hp.global_bsz % hp.chunks != 0:
        raise ValueError("global_bsz must divide into chunks")


# ----------------------------------------------- the reference's stacked trees
def _tree_map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def unstack_params(stacked: Sequence[Any], hp: HybridParallelConfig) -> List[Any]:
    """The reference's ``stages`` ([max layers per stage trees with a
    leading pp dim]; a short stage's trailing slots are zero padding) ->
    the canonical per-layer list."""
    layers: List[Any] = [None] * len(hp.layers)
    for s in range(hp.pp):
        for j, i in enumerate(hp.layers_of_stage(s)):
            layers[i] = _tree_map(lambda x, _s=s: np.asarray(x)[_s], stacked[j])
    return layers


# ------------------------------------------------------------------ schedules
class Step(NamedTuple):
    """One entry of a stage's schedule. ``F``/``B``: micro-batch `mb`'s
    forward / backward on this stage. ``X``: one exchange with a neighbour:
    `sends` and `recvs` hold ``("fwd", mb)`` (an activation to the next
    stage / from the previous one) or ``("bwd", mb)`` (a cotangent to the
    previous stage / from the next one)."""

    kind: str
    mb: int = -1
    sends: Tuple[Tuple[str, int], ...] = ()
    recvs: Tuple[Tuple[str, int], ...] = ()


def gpipe_order(pp: int, chunks: int, stage: int, backward: bool = True) -> List[Step]:
    """GPipe on `stage`: every micro-batch forward, then every backward
    (`backward` False: the forward-only pipeline of eval)."""
    first, last = stage == 0, stage == pp - 1
    out: List[Step] = []
    for i in range(chunks):
        if not first:
            out.append(Step("X", recvs=(("fwd", i),)))
        out.append(Step("F", i))
        if not last:
            out.append(Step("X", sends=(("fwd", i),)))
    if backward:
        for i in range(chunks):
            if not last:
                out.append(Step("X", recvs=(("bwd", i),)))
            out.append(Step("B", i))
            if not first:
                out.append(Step("X", sends=(("bwd", i),)))
    return out


# --------------------------------------------------------------- stage runner
class StageRunner:
    """One stage's micro-batches. `body(batch, inputs)` is the stage's
    forward (a family's ``stage_body``): from the batch and the tuple of
    tensors the previous stage sent (None on the first stage) to the tuple
    it sends on, or on the last stage to the family's loss, which is
    weighted here and summed into `loss`. `backward` runs from the
    received cotangents (the last stage from its loss) and returns the
    cotangents of its inputs. Each in-flight micro-batch keeps (inputs,
    outputs) until its backward. An output may be an input passed on (a
    pass-through leaf): autograd accumulates its cotangent into the
    input's gradient with the rest."""

    def __init__(self, stage: int, body: Callable, hp: HybridParallelConfig):
        self.body, self.last = body, stage == hp.pp - 1
        self.stash: Dict[int, Tuple[Optional[Tuple[torch.Tensor, ...]], Any]] = {}
        self.loss: Optional[torch.Tensor] = None  # the last stage's weighted sum

    def forward(self, mb: int, batch: Dict[str, torch.Tensor],
                x_in: Optional[Tuple[torch.Tensor, ...]],
                weight: Optional[torch.Tensor] = None):
        grad = torch.is_grad_enabled()
        if x_in is not None and grad:
            x_in = tuple(t.requires_grad_() for t in x_in)
        out = self.body(batch, x_in)
        if self.last:
            out = out * weight
            share = out.detach()
            self.loss = share if self.loss is None else self.loss + share
        if grad:
            self.stash[mb] = (x_in, out)
        return None if self.last else out

    def backward(self, mb: int, grad: Optional[Tuple[torch.Tensor, ...]]):
        x_in, out = self.stash.pop(mb)
        torch.autograd.backward(out, grad)
        return None if x_in is None else tuple(t.grad for t in x_in)


# ------------------------------------------------------------------ transports
# (stage, micro-batch, the tuple it received) -> the tuple it sends
StepFn = Callable[[int, int, Optional[Tuple[torch.Tensor, ...]]],
                  Optional[Tuple[torch.Tensor, ...]]]
# (micro-batch, stage) -> [(shape, dtype)] of each tensor stage `stage`
# sends to stage + 1 (and of its cotangent coming back)
BoundaryFn = Callable[[int, int], List[Tuple[Tuple[int, ...], torch.dtype]]]


class Transport:
    """The seam every cross-stage movement and reduction goes through.
    Values are keyed by the stages this process hosts; a reduction takes
    every hosted stage's value and gives each the result."""

    stages: Tuple[int, ...]

    def run(self, orders: Dict[int, List[Step]], forward: StepFn, backward: StepFn,
            boundary: BoundaryFn) -> None:
        """Run each hosted stage's schedule: ``forward(stage, mb, x_in)``
        returns the tuple a ``("fwd", mb)`` send carries (None on the last
        stage), ``backward(stage, mb, grad)`` the tuple a ``("bwd", mb)``
        send carries (None on the first); ``boundary(mb, s)`` is the
        (shape, dtype) of each tensor micro-batch `mb` sends from stage
        `s` to `s + 1` (its cotangent has the same)."""
        raise NotImplementedError

    def reduce(self, values: Dict[int, torch.Tensor], op: str = "sum") -> Dict[int, torch.Tensor]:
        """Sum (or max) over every stage."""
        raise NotImplementedError

    def sum_shared(self, values: Dict[int, torch.Tensor], holders: Tuple[int, ...],
                   like) -> Dict[int, torch.Tensor]:
        """Sum the values of the stages `holders` (the gradients of a
        parameter several stages hold: a tied embedding's copies, a table
        that layers on several stages read); `values` holds the hosted
        holders' ones and the sum comes back to each. `like` is the
        (shape, dtype) of a value, for a stage that holds none."""
        raise NotImplementedError

    def copy_shared(self, values: Dict[int, torch.Tensor], holders: Tuple[int, ...],
                    like) -> None:
        """Copy the first holder's value into every other holder's, in
        place (a shared parameter restored from the one copy a checkpoint
        holds)."""
        raise NotImplementedError

    def from_last(self, values: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Every stage gets the last stage's value (the others pass a
        buffer of its shape)."""
        raise NotImplementedError

    def gather(self, values: Dict[int, Dict[str, torch.Tensor]]) -> List[Dict[str, torch.Tensor]]:
        """Every stage's name -> tensor dict, in stage order (collective;
        the tensors may come back on the CPU)."""
        raise NotImplementedError


class LocalTransport(Transport):
    """Every stage in this process: the schedules run round robin, each
    stage until it waits for a hand-off that has not been made; hand-offs
    are clones. A full round without progress is a schedule bug and
    raises."""

    def __init__(self, pp: int):
        self.pp = pp
        self.stages = tuple(range(pp))

    def run(self, orders, forward, backward, boundary) -> None:
        mailbox: Dict[Tuple[str, int, int], torch.Tensor] = {}
        outbox: Dict[int, Dict[Tuple[str, int], torch.Tensor]] = {s: {} for s in orders}
        inbox: Dict[int, Dict[Tuple[str, int], torch.Tensor]] = {s: {} for s in orders}
        pos = {s: 0 for s in orders}
        posted = set()
        while any(pos[s] < len(orders[s]) for s in orders):
            progressed = False
            for s in sorted(orders):
                while pos[s] < len(orders[s]):
                    step = orders[s][pos[s]]
                    if step.kind == "X":
                        if (s, pos[s]) not in posted:
                            for kind, mb in step.sends:
                                dest = s + 1 if kind == "fwd" else s - 1
                                mailbox[(kind, dest, mb)] = tuple(
                                    t.detach().clone() for t in outbox[s].pop((kind, mb)))
                            posted.add((s, pos[s]))
                        if not all((kind, s, mb) in mailbox for kind, mb in step.recvs):
                            break
                        for kind, mb in step.recvs:
                            inbox[s][(kind, mb)] = mailbox.pop((kind, s, mb))
                    elif step.kind == "F":
                        out = forward(s, step.mb, inbox[s].pop(("fwd", step.mb), None))
                        if out is not None:
                            outbox[s][("fwd", step.mb)] = out
                    else:
                        out = backward(s, step.mb, inbox[s].pop(("bwd", step.mb), None))
                        if out is not None:
                            outbox[s][("bwd", step.mb)] = out
                    pos[s] += 1
                    progressed = True
            if not progressed:
                raise RuntimeError("pipeline schedule deadlocked at steps %s" % {
                    s: orders[s][pos[s]] for s in orders if pos[s] < len(orders[s])})

    def reduce(self, values, op="sum"):
        order = [values[s] for s in sorted(values)]
        total = order[0]
        for v in order[1:]:
            total = torch.maximum(total, v) if op == "max" else total + v
        return {s: total.clone() for s in values}

    def sum_shared(self, values, holders, like):
        total = sum(values[s] for s in holders)
        return {s: total.clone() for s in holders}

    def from_last(self, values):
        return {s: values[self.pp - 1].clone() for s in values}

    def copy_shared(self, values, holders, like) -> None:
        with torch.no_grad():
            for s in holders[1:]:
                values[s].copy_(values[holders[0]])

    def gather(self, values):
        return [values[s] for s in range(self.pp)]


class P2PTransport(Transport):
    """This process is one stage (`mesh`'s pp coordinate): exchanges go to
    the neighbouring stages' ranks with the same within-stage coordinate,
    reductions over the pp group, the tied sum over the embedding group.
    Without a pipeline it is the one stage: its schedule has no exchange
    and its pp group is the rank's own one-rank group."""

    def __init__(self, mesh):
        import torch.distributed as dist

        from galvatron_tpu_torch.parallel.mesh import EMBED_GROUP, PP_AXIS

        self.mesh = mesh
        self.pp = mesh.shape[0]
        self.stage = mesh.stage
        self.stages = (self.stage,)
        self.next = mesh.stage_rank(self.stage + 1) if self.stage < self.pp - 1 else None
        self.prev = mesh.stage_rank(self.stage - 1) if self.stage > 0 else None
        self.last_rank = mesh.stage_rank(self.pp - 1)
        self._pp_axes = (PP_AXIS,) if self.pp > 1 else ()
        if self.pp > 1:
            self.embed_group = mesh.group_for(EMBED_GROUP)
            # NCCL wants a collective on the default group before the first
            # batched point-to-point call
            dist.all_reduce(torch.zeros(1, device=mesh.device))

    @property
    def pp_group(self):
        # looked up at first use: a world of one makes its groups then
        return self.mesh.group_for(self._pp_axes)

    def run(self, orders, forward, backward, boundary) -> None:
        import torch.distributed as dist

        outbox: Dict[Tuple[str, int], torch.Tensor] = {}
        inbox: Dict[Tuple[str, int], torch.Tensor] = {}
        for step in orders[self.stage]:
            if step.kind == "F":
                out = forward(self.stage, step.mb, inbox.pop(("fwd", step.mb), None))
                if out is not None:
                    outbox[("fwd", step.mb)] = out
            elif step.kind == "B":
                out = backward(self.stage, step.mb, inbox.pop(("bwd", step.mb), None))
                if out is not None:
                    outbox[("bwd", step.mb)] = out
            else:
                ops = []
                for kind, mb in step.sends:
                    for t in outbox.pop((kind, mb)):
                        ops.append(dist.P2POp(dist.isend, t.detach().contiguous(),
                                              self.next if kind == "fwd" else self.prev))
                for kind, mb in step.recvs:
                    fwd = kind == "fwd"
                    bufs = tuple(torch.empty(shape, dtype=dtype, device=self.mesh.device)
                                 for shape, dtype in boundary(mb, self.stage - fwd))
                    ops.extend(dist.P2POp(dist.irecv, buf, self.prev if fwd else self.next)
                               for buf in bufs)
                    inbox[(kind, mb)] = bufs
                for work in dist.batch_isend_irecv(ops):
                    work.wait()

    def reduce(self, values, op="sum"):
        import torch.distributed as dist

        v = values[self.stage]
        dist.all_reduce(v, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                        group=self.pp_group)
        return {self.stage: v}

    def _over(self, holders):
        """(group, is this stage a member): the embedding group for the
        first and the last stage, else the pp group, where a stage that
        holds nothing takes part with zeros."""
        if tuple(holders) == (0, self.pp - 1):
            return self.embed_group, self.stage in holders
        return self.pp_group, True

    def sum_shared(self, values, holders, like):
        import torch.distributed as dist

        group, member = self._over(holders)
        if not member:
            return {}
        v = values.get(self.stage)
        if v is None:
            v = torch.zeros(like[0], dtype=like[1], device=self.mesh.device)
        dist.all_reduce(v, group=group)
        return {self.stage: v} if self.stage in holders else {}

    def from_last(self, values):
        import torch.distributed as dist

        v = values[self.stage]
        dist.broadcast(v, src=self.last_rank, group=self.pp_group)
        return {self.stage: v}

    def copy_shared(self, values, holders, like) -> None:
        import torch.distributed as dist

        group, member = self._over(holders)
        if not member:
            return
        v = values.get(self.stage)
        if v is None:
            v = torch.empty(like[0], dtype=like[1], device=self.mesh.device)
        with torch.no_grad():
            dist.broadcast(v, src=self.mesh.stage_rank(holders[0]), group=group)

    def gather(self, values):
        import torch.distributed as dist

        if self.pp == 1:
            return [values[self.stage]]
        out = [None] * self.pp
        dist.all_gather_object(out, {n: t.cpu() for n, t in values[self.stage].items()},
                               group=self.pp_group)
        return out
