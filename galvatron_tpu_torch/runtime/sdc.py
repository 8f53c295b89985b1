"""Silent-data-corruption sentinel: digests, replica voting, quarantine.

Port of ``galvatron_tpu/runtime/sdc.py``. The guard catches non-finite
losses, the watchdog hangs and the mesh probe lost ranks; a card that
returns finite but wrong numbers passes all three, poisons the Adam moments
and gets sealed into checkpoints that call themselves intact. The train
driver wires this module in under ``--sdc_check``, in three legs:

1. **Digests** (`state_fold`): a layout-invariant fold of the logical
   state. Every leaf's uint32 words are summed mod 2^32 (``ops/tree_fold``:
   the hand-written kernel on the card, its plain version on the CPU), so
   the fold is the same whatever the order or the sharding. The reference
   folds each logical array once inside one jitted program; here the same
   array lies on several processes as dp replicas, disjoint ZeRO-3 and TP
   shards and, under pp, a tied table on two stages. So each rank folds the
   shards it *owns* (`owned`: index 0 on every axis that replicates the
   leaf; a stage's copy of a shared parameter never) in one kernel launch,
   and the folds are summed mod 2^32 over the world: each logical element
   counts once. The fp32 sum of squares rides along for telemetry (not
   order-exact; only the fold is compared). `host_tree_fold` is the
   host-side twin over a whole tree.

2. **Cross-replica voting** (`make_vote_digest_fn` + `VoteLadder`): pure-dp
   layouts hold a full replica of the parameters on every rank. Each rank
   folds its *whole* local replica of the step's input params, and the
   folds are all-gathered over the dp group: a rank whose memory or ALU
   lies shows a divergent fold and is localized. The step then applies
   nothing (the anomaly guard's keep-old path); the driver repairs the
   suspects from a healthy replica (`repair_from_replica`: a broadcast of
   the params and both Adam moments), re-executes the step, and escalates
   a rank that keeps striking through `VoteLadder` into a quarantine that
   ``runtime/health.MeshHealthMonitor`` turns into a live migration off it
   (``--migrate_on_degrade``).

3. **Digest continuity across state motion** (`assert_digest_continuity`):
   a live migration (``runtime/elastic.migrate``) and a cross-strategy
   restore move values without changing them; the layout-invariant fold
   proves it or the run refuses with GLS016.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from galvatron_tpu_torch.ops.tree_fold import MASK32, tree_fold, tree_fold_reference

SDC_MODES = ("off", "digest", "vote")
_MASK32 = MASK32


# ------------------------------------------------------------------ leaves
def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree: an ``nn.Module``'s parameters, a mapping's
    values (recursively), an Adam state's moments and count, sequences,
    tensors and numpy arrays. The fold does not depend on the order."""
    from galvatron_tpu_torch.runtime.optimizer import AdamState

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        a = np.asarray(tree)
        return [torch.from_numpy(np.ascontiguousarray(a.view(np.uint16) if a.dtype.name
                                                      == "bfloat16" else a))]
    if isinstance(tree, nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, AdamState):
        return ([torch.tensor(int(tree.count), dtype=torch.int64)]
                + tree_leaves(tree.mu) + tree_leaves(tree.nu))
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_leaves(x)]
    if tree is None:
        return []
    raise TypeError("tree fold: cannot take the leaves of a %s" % type(tree).__name__)


def tree_fold_metrics(tree) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fold, sumsq) of every leaf of `tree`, on the leaves' device without
    a host sync: one kernel launch on the card, the plain version on the
    CPU (``ops/tree_fold.tree_fold``)."""
    return tree_fold(tree_leaves(tree))


def host_tree_fold(tree) -> int:
    """The fold of `tree` computed on the host (its leaves copied there),
    as a Python int: the twin of the reference's ``host_tree_fold``."""
    fold, _ = tree_fold_reference([t.detach().cpu() for t in tree_leaves(tree)])
    return int(fold) & _MASK32


# ---------------------------------------------------------- layout-invariant
def owned(model, name: str, stage: int, spec) -> bool:
    """True when this process's shard of `name` on `stage` (placed as
    `spec`) is the one that counts in a fold of the logical state: index 0
    on every within-stage axis that replicates it, and not a stage's copy
    of a parameter an earlier stage holds (the tied table)."""
    if model._copy(name, stage):
        return False
    mesh = model.stage_meshes[stage]
    sharded = {a for ax in spec for a in ax}
    return all(mesh.coord[a] == 0 for a in mesh.names[1:] if a not in sharded)


def owned_leaves(model, params, opt_state=None) -> List[torch.Tensor]:
    """This process's owned shards (`owned`) of the params and, with
    `opt_state`, of both Adam moments, over every hosted stage."""
    out = []
    specs = {n: pl.spec for n, pl in model.param_layouts.items()}
    moment_specs = model.grad_accum_specs() if opt_state is not None else None
    for s, module in params.items():
        for n, p in module.named_parameters():
            if owned(model, n, s, specs[n]):
                out.append(p)
        if opt_state is not None:
            st = opt_state[s]
            for n in st.mu:
                if owned(model, n, s, moment_specs[n]):
                    out.extend((st.mu[n], st.nu[n]))
    return out


def _world_sum(v: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(v)
    return v


def state_fold_metrics(model, params, opt_state=None) -> torch.Tensor:
    """float64 [fold sum, sumsq] of the logical state over the world, on
    the device and without a host sync: one fold launch over this process's
    owned shards, then one all-reduce (collective: every rank calls it).
    The fold is ``int(v[0]) mod 2^32`` (`fold_value`)."""
    fold, sumsq = tree_fold(owned_leaves(model, params, opt_state))
    if opt_state is not None and model.stages[0] in opt_state and _lead_stage(model):
        fold = fold + int(opt_state[model.stages[0]].count) % (1 << 32)
    # on the model's device even where this rank owns nothing (NCCL reduces
    # device tensors only)
    return _world_sum(torch.stack([fold.double(), sumsq.double()]).to(model.device))


def _lead_stage(model) -> bool:
    """True on the one process whose first hosted stage is stage 0 at
    within-stage coordinate 0 (where a state's scalar counts once)."""
    mesh = model.stage_meshes[model.stages[0]]
    return model.stages[0] == 0 and all(mesh.coord[a] == 0 for a in mesh.names[1:])


def fold_value(metrics: torch.Tensor) -> Tuple[int, float]:
    """(fold, sumsq) on the host from `state_fold_metrics`' output."""
    total, sumsq = metrics.tolist()
    return int(total) & _MASK32, float(sumsq)


def state_fold(model, params, opt_state=None) -> int:
    """The layout-invariant fold of the logical params (and, with
    `opt_state`, of both moments and the Adam count) as an int: the same
    under every strategy that holds the same values. Collective."""
    return fold_value(state_fold_metrics(model, params, opt_state))[0]


# ----------------------------------------------------------- replica voting
def vote_reason(hp) -> Optional[str]:
    """None when per-replica voting is expressible for this strategy, else
    the reason it is not: every non-dp form of parallelism must be off (a
    sharded replica is not a replica) and the optimizer state must be
    dp-replicated, so a lying rank can be repaired from any healthy peer.
    strategy_lint mirrors this as a GLS103 downgrade warning; the train
    driver falls back to digest mode."""
    if hp.pp > 1:
        return ("pp=%d: pipeline stages hold disjoint layer shards, not "
                "full replicas" % hp.pp)
    for i, s in enumerate(hp.layers):
        if s.tp > 1 or s.cp > 1 or s.sp:
            return ("layer %d: tp=%d cp=%d sp=%d shard the parameters; "
                    "voting needs a full per-device replica (pure-dp "
                    "layout)" % (i, s.tp, s.cp, int(s.sp)))
        if s.fsdp:
            return ("layer %d: fsdp=1 (ZeRO-3) shards parameters over dp; "
                    "there is no per-device replica to vote on" % i)
    if hp.vocab_tp > 1 or hp.vocab_cp > 1 or getattr(hp, "embed_sdp", 0):
        return ("embed/head sharding (vtp=%d vcp=%d embed_sdp=%d) leaves "
                "no full per-device replica"
                % (hp.vocab_tp, hp.vocab_cp, int(getattr(hp, "embed_sdp", 0))))
    if getattr(hp, "default_dp_type", "ddp") != "ddp":
        return ("default_dp_type=%r shards optimizer state over dp; replica "
                "repair needs dp-replicated state" % hp.default_dp_type)
    if hp.dp(0) < 2:
        return "dp=1: voting needs at least two data-parallel replicas"
    return None


def vote_supported(model) -> Tuple[bool, Optional[str]]:
    """(ok, reason) for a built model."""
    reason = vote_reason(model.hp)
    return reason is None, reason


def dp_axes_of(model) -> Tuple[str, ...]:
    """The dp axes of the voting group (layer 0's: under `vote_reason`'s
    envelope every layer and the vocab layers share them)."""
    from galvatron_tpu_torch.parallel.mesh import layer_axes

    return tuple(layer_axes(model.hp, 0).dp)


def vote_device_ids(model) -> List[int]:
    """The global rank behind each vote, in the order of
    `make_vote_digest_fn`'s output (the dp group's ranks, ascending: a
    process group's order)."""
    return sorted(model.mesh.ranks(dp_axes_of(model)))


def make_vote_digest_fn(model):
    """``params -> int64[dp]``: each rank's fold of its whole local replica
    of the params (one kernel launch), all-gathered over the dp group, in
    the order of `vote_device_ids`. Collective over the dp group."""
    import torch.distributed as dist

    dp = dp_axes_of(model)
    n = model.mesh.size(dp)

    def vote(params):
        fold, _ = tree_fold([p for m in params.values() for p in m.parameters()])
        out = [torch.empty_like(fold) for _ in range(n)]
        dist.all_gather(out, fold.contiguous(), group=model.mesh.group_for(dp))
        return torch.stack(out)

    return vote


@dataclass
class VoteLadder:
    """Host-side strike ladder over per-replica fold votes.

    One :meth:`observe` per drained vote round. A unanimous round resets
    the ladder. A round with a strict-majority fold localizes the
    dissenting rank(s); each consecutive localization strikes them, and
    ``strikes`` consecutive strikes escalate to a ``quarantine`` action. A
    tied round (e.g. dp=2 disagreeing 1-1) is a detection without a
    culprit: re-execute, never quarantine."""

    strikes: int = 2
    _consecutive: Dict[int, int] = field(default_factory=dict, repr=False)

    def observe(self, folds: Sequence[int], device_ids: Sequence[int]) -> Dict[str, Any]:
        folds = [int(f) for f in folds]
        ids = [int(i) for i in device_ids]
        counts: Dict[int, int] = {}
        for f in folds:
            counts[f] = counts.get(f, 0) + 1
        majority_fold, majority_n = max(counts.items(), key=lambda kv: kv[1])
        if len(counts) == 1:
            self._consecutive.clear()
            return {"ok": True, "action": "none", "suspects": [],
                    "quarantine": [], "strikes": {}}
        if majority_n * 2 <= len(folds):
            # no strict majority: detected, not localizable
            return {"ok": False, "action": "reexecute", "suspects": [],
                    "quarantine": [], "strikes": dict(self._consecutive)}
        suspects = [i for i, f in zip(ids, folds) if f != majority_fold]
        for d in list(self._consecutive):
            if d not in suspects:
                del self._consecutive[d]
        for d in suspects:
            self._consecutive[d] = self._consecutive.get(d, 0) + 1
        quarantine = [d for d in suspects if self._consecutive[d] >= self.strikes]
        return {
            "ok": False,
            "action": "quarantine" if quarantine else "reexecute",
            "suspects": suspects,
            "quarantine": quarantine,
            "strikes": dict(self._consecutive),
            "majority_fold": majority_fold,
        }

    def reset(self) -> None:
        self._consecutive.clear()


def repair_from_replica(model, params, opt_state, bad_ranks: Iterable[int]) -> int:
    """Overwrite every replica of the params and both Adam moments with the
    copy of the first rank of the dp group that is not in `bad_ranks`
    (one broadcast per tensor over the dp group; collective). Under
    `vote_reason`'s envelope every rank holds the whole state, so this
    restores agreement, the lying rank's copy included. Returns the source
    rank."""
    import torch.distributed as dist

    bad = {int(r) for r in bad_ranks}
    ranks = vote_device_ids(model)
    healthy = [r for r in ranks if r not in bad]
    src = healthy[0] if healthy else ranks[0]
    group = model.mesh.group_for(dp_axes_of(model))
    with torch.no_grad():
        for m in params.values():
            for p in m.parameters():
                dist.broadcast(p.data, src=src, group=group)
        for st in (opt_state or {}).values():
            for n in st.mu:
                dist.broadcast(st.mu[n], src=src, group=group)
                dist.broadcast(st.nu[n], src=src, group=group)
    return src


# ------------------------------------------------------- digest continuity
def assert_digest_continuity(before_fold: int, after, where: str,
                             iteration: Optional[int] = None) -> int:
    """Assert that the layout-invariant fold after a value-preserving state
    motion (`after`: the fold, or a tree to fold on the host) equals
    `before_fold`. Raises a GLS016 DiagnosticError on a mismatch (refusing
    garbled state beats training on it); returns the fold and emits an
    ``sdc_check mode="continuity"`` event on success."""
    from galvatron_tpu_torch.obs import telemetry

    got = int(after) if isinstance(after, (int, np.integer)) else host_tree_fold(after)
    got &= _MASK32
    if got != int(before_fold) & _MASK32:
        from galvatron_tpu_torch.analysis import diagnostics as D

        raise D.DiagnosticError([D.make(
            "GLS016",
            "%s: layout-invariant digest changed 0x%08x -> 0x%08x; the "
            "state motion was not value-preserving: refusing to continue "
            "on garbled state" % (where, int(before_fold) & _MASK32, got),
        )])
    telemetry.emit("sdc_check", mode="continuity", where=where, iter=iteration, fold=got)
    return got
