"""The rank grid, per-layer axis assignment and process groups.

Port of ``galvatron_tpu/parallel/mesh.py``. The per-stage device block is
factored into binary sub-axes ``m0 .. m{k-1}`` (major -> minor) and each
layer's strategy becomes an assignment of sub-axes to the tp, cp and dp
roles. `config.strategy.layer_runs` groups layers by this *realised*
assignment, so inert flag differences (``sp`` or ``tp_consec`` at tp=1) do
not split a run — exactly as in the reference.

Where the reference builds one ``jax.sharding.Mesh`` and lets XLA derive the
collectives, `build_mesh` lays the ranks out on the same grid, shape
``(pp,) + subaxis_sizes(per_stage)`` in row-major order (the reference's
``np.array(devices).reshape(shape)``), and `RankMesh.group_for` returns the
``torch.distributed`` group over any tuple of sub-axes: the ranks that share
this rank's coordinate on every other axis, ordered row-major over the named
axes, so a dim sharded over axes ``(a, b)`` holds shard ``index(a, b) =
coord[a] * size[b] + coord[b]`` on each rank, as a ``PartitionSpec`` entry
``(a, b)`` does.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

PP_AXIS = "pp"
# the key of the group of a rank's first- and last-stage peers (`group_for`)
EMBED_GROUP = "embed"


def subaxis_sizes(per_stage: int) -> Tuple[int, ...]:
    """Factor the per-pipeline-stage device count into binary sub-axes
    (major -> minor), with any odd remainder as a single leading axis."""
    sizes = []
    n = per_stage
    while n % 2 == 0 and n > 1:
        sizes.append(2)
        n //= 2
    if n > 1:
        sizes.insert(0, n)
    return tuple(sizes)


def subaxis_names(per_stage: int) -> Tuple[str, ...]:
    return tuple("m%d" % i for i in range(len(subaxis_sizes(per_stage))))


@dataclass(frozen=True)
class LayerAxes:
    """The sub-axis assignment realising one layer's strategy: ``dp``/``cp``/
    ``tp`` are tuples of sub-axis names (major -> minor); ``ulysses`` marks
    the tp axes carrying Ulysses sequence parallelism, ``megatron_sp``
    Megatron-SP activation sharding."""

    dp: Tuple[str, ...]
    cp: Tuple[str, ...]
    tp: Tuple[str, ...]
    ulysses: bool = False
    megatron_sp: bool = False
    zero3: bool = False
    zero_opt: bool = False  # optimizer state sharded over dp (zero1/2/3)

    @property
    def seq_axes(self) -> Tuple[str, ...]:
        """Axes sharding the sequence dim of activations *between* layers:
        cp always; plus tp when this layer does ulysses or megatron-sp."""
        ax = tuple(self.cp)
        if self.ulysses or self.megatron_sp:
            ax += tuple(self.tp)
        return ax

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return self.dp


def _assign(names, sizes, tp: int, cp: int, tp_consec: bool):
    """Split sub-axes into (dp, cp, tp) groups by degree products."""

    def take_minor(names_left, sizes_left, degree, what):
        taken = []
        prod = 1
        while prod < degree:
            if not names_left:
                raise ValueError("cannot realise %s degree %d from sub-axes %s" % (what, degree, sizes))
            taken.insert(0, names_left[-1])
            prod *= sizes_left[-1]
            names_left, sizes_left = names_left[:-1], sizes_left[:-1]
        if prod != degree:
            raise ValueError("%s degree %d not a product of minor sub-axes %s" % (what, degree, sizes))
        return names_left, sizes_left, tuple(taken)

    if not tp_consec and tp > 1:
        # tp on the MAJOR axes: reverse, assign, un-reverse.
        rn, rs = tuple(reversed(names)), tuple(reversed(sizes))
        rn_left, rs_left, tp_ax = take_minor(rn, rs, tp, "tp")
        rn_left, rs_left, cp_ax = take_minor(rn_left, rs_left, cp, "cp")
        dp_ax = tuple(reversed(rn_left))
        return dp_ax, tuple(reversed(cp_ax)), tuple(reversed(tp_ax))
    names_left, sizes_left, tp_ax = take_minor(names, sizes, tp, "tp")
    names_left, sizes_left, cp_ax = take_minor(names_left, sizes_left, cp, "cp")
    return tuple(names_left), cp_ax, tp_ax


def _axes_from_strategy(config, tp: int, cp: int, ulysses: bool,
                        tp_consec: bool, fsdp: bool) -> LayerAxes:
    names = subaxis_names(config.per_stage_devices)
    sizes = subaxis_sizes(config.per_stage_devices)
    dp_ax, cp_ax, tp_ax = _assign(names, sizes, tp, cp, tp_consec)
    dp_type = "zero3" if fsdp else config.default_dp_type
    return LayerAxes(
        dp=dp_ax,
        cp=cp_ax,
        tp=tp_ax,
        ulysses=ulysses and tp > 1,
        megatron_sp=config.sequence_parallel and tp > 1 and not ulysses,
        zero3=dp_type == "zero3",
        zero_opt=dp_type in ("zero2", "zero3"),
    )


def layer_axes(config, layer_idx: int) -> LayerAxes:
    s = config.layers[layer_idx]
    return _axes_from_strategy(config, s.tp, s.cp, bool(s.sp), bool(s.tp_consec), bool(s.fsdp))


def vocab_axes(config) -> LayerAxes:
    """Axes for the embedding / lm-head layers (vocab_tp/vocab_sp/vocab_cp)."""
    return _axes_from_strategy(
        config, config.vocab_tp, config.vocab_cp, bool(config.vocab_sp), True,
        bool(config.embed_sdp),
    )


# ------------------------------------------------------------------ rank grid
class RankMesh:
    """This rank's place on the grid ``(pp, m0, .., m{k-1})`` and the
    process groups over its sub-axes.

    `grid` holds the global ranks in row-major order; `coord` maps each axis
    name to this rank's coordinate. Groups are created by `create_groups`,
    which every rank must call at the same point: ``new_group`` is collective
    over the whole world, so the groups of EVERY subset of the stage's
    sub-axes (the empty subset included: a one-rank group per rank) are made
    up front, in one order on every rank, including the groups a rank is not
    in (once per default group: later meshes reuse them); with more than one
    stage, then the pp groups (a rank's peers on every stage) and the
    embedding groups (its first- and last-stage peers, ``EMBED_GROUP``).
    `group_for` then only looks them up."""

    def __init__(self, config, rank: int = 0, device=None):
        per_stage = config.per_stage_devices
        self.shape = (config.pp,) + subaxis_sizes(per_stage)
        self.names = (PP_AXIS,) + subaxis_names(per_stage)
        self.world_size = int(np.prod(self.shape))
        if self.world_size != config.world_size:
            raise ValueError("mesh shape %s holds %d ranks, the strategy asks for %d"
                             % (self.shape, self.world_size, config.world_size))
        if not 0 <= rank < self.world_size:
            raise ValueError("rank %d outside a world of %d" % (rank, self.world_size))
        self.rank = rank
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.grid = np.arange(self.world_size).reshape(self.shape)
        self.sizes: Dict[str, int] = dict(zip(self.names, self.shape))
        self.coord: Dict[str, int] = {
            n: int(c) for n, c in zip(self.names, np.unravel_index(rank, self.shape))}
        self._groups: Optional[Dict[Tuple[str, ...], object]] = None
        self.hosted = False

    @classmethod
    def hosted_stage(cls, config, stage: int, device=None) -> "RankMesh":
        """Stage `stage` of a strategy whose stages hold one device each,
        hosted with every other stage by one process
        (``parallel.pipeline.LocalTransport``): its coordinate is the
        stage's rank, and its one within-stage group (over no axes) is the
        process's one-rank group. It has no pp or embedding group: the
        transport moves and reduces across stages."""
        if config.per_stage_devices != 1:
            raise ValueError("one process hosts every stage only when each stage holds one "
                             "device; this strategy gives each stage %d"
                             % config.per_stage_devices)
        mesh = cls(config, stage, device)
        mesh.hosted = True
        return mesh

    # ------------------------------------------------------------ arithmetic
    def _check(self, axes: Sequence[str], grid_order: bool = True) -> Tuple[str, ...]:
        axes = tuple(axes)
        pos = [self.names.index(a) for a in axes]
        if len(set(pos)) != len(pos) or (grid_order and pos != sorted(pos)):
            raise ValueError("axes %s must be distinct%s" % (
                axes, " and in grid order %s" % (self.names,) if grid_order else ""))
        return axes

    def in_grid_order(self, axes: Sequence[str]) -> bool:
        pos = [self.names.index(a) for a in axes]
        return pos == sorted(pos)

    def size(self, axes: Sequence[str]) -> int:
        """The number of ranks over `axes` (in any order)."""
        return int(np.prod([self.sizes[a] for a in self._check(axes, grid_order=False)],
                           dtype=np.int64))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over `axes` (0 for no axes)."""
        return self.shard_index(self._check(axes))

    def shard_index(self, axes: Sequence[str]) -> int:
        """The shard of a dim placed on `axes` this rank holds: its
        row-major index over them, major first, in the order given (a dim
        on ``(cp, tp)`` with tp on the grid's major axes included)."""
        idx = 0
        for a in self._check(axes, grid_order=False):
            idx = idx * self.sizes[a] + self.coord[a]
        return idx

    def ranks(self, axes: Sequence[str]) -> Tuple[int, ...]:
        """The global ranks of this rank's group over `axes`, row-major."""
        return self._cosets(self._check(axes))[self._coset_key(axes)]

    def _coset_key(self, axes) -> Tuple[int, ...]:
        return tuple(self.coord[n] for n in self.names if n not in axes)

    def _cosets(self, axes: Tuple[str, ...]) -> Dict[Tuple[int, ...], Tuple[int, ...]]:
        """Every group over `axes`, keyed by the coordinates of the other
        axes, in row-major order of those coordinates."""
        keep = [i for i, n in enumerate(self.names) if n in axes]
        other = [i for i, n in enumerate(self.names) if n not in axes]
        grid = np.transpose(self.grid, other + keep)
        out = {}
        for key in itertools.product(*[range(self.shape[i]) for i in other]):
            out[tuple(key)] = tuple(int(r) for r in grid[key].reshape(-1))
        return out

    # ------------------------------------------------------------- pipeline
    @property
    def stage(self) -> int:
        """This rank's pipeline stage (its pp coordinate)."""
        return self.coord[PP_AXIS]

    def stage_rank(self, stage: int) -> int:
        """The global rank of `stage` with this rank's within-stage
        coordinate: the neighbour a pipeline hands activations to (stage
        + 1) and cotangents to (stage - 1)."""
        if not 0 <= stage < self.shape[0]:
            raise ValueError("stage %d outside a pipeline of %d" % (stage, self.shape[0]))
        return int(self.grid[(stage,) + tuple(self.coord[n] for n in self.names[1:])])

    # ---------------------------------------------------------------- groups
    def axis_subsets(self) -> Tuple[Tuple[str, ...], ...]:
        """Every subset of the within-stage sub-axes, then, with more than
        one stage, the pp axis alone (a rank's peers on every stage)."""
        subs = self.names[1:]
        out = tuple(c for k in range(len(subs) + 1) for c in itertools.combinations(subs, k))
        return out + ((PP_AXIS,),) if self.shape[0] > 1 else out

    def create_groups(self) -> None:
        """Create the groups of every subset of the sub-axes (see the class
        note); a no-op once done."""
        import torch.distributed as dist

        from galvatron_tpu_torch.runtime.distributed import backend_for, subgroup

        if self._groups is not None:
            return
        if not dist.is_initialized():
            raise RuntimeError("RankMesh.create_groups needs an initialized process group "
                               "(runtime/distributed.py)")
        if dist.get_world_size() != self.world_size or dist.get_rank() != self.rank:
            raise ValueError("process group is rank %d of %d; the mesh expects rank %d of %d"
                             % (dist.get_rank(), dist.get_world_size(), self.rank,
                                self.world_size))
        backend = backend_for(self.device)
        groups = {}
        for axes in self.axis_subsets():
            mine = self._coset_key(axes)
            for key, ranks in self._cosets(axes).items():
                g = subgroup(ranks, backend)
                if key == mine:
                    groups[axes] = g
        if self.shape[0] > 1:
            # per within-stage coordinate, the first and the last stage's
            # ranks: the group that sums a tied table's two copies
            mine = self._coset_key((PP_AXIS,))
            for key, ranks in self._cosets((PP_AXIS,)).items():
                g = subgroup((ranks[0], ranks[-1]), backend)
                if key == mine:
                    groups[EMBED_GROUP] = g
        self._groups = groups

    def group_for(self, axes: Sequence[str]):
        """The process group over `axes` (row-major). A mesh built before
        its world of one had a default group creates its groups here, at
        first use; with more ranks, groups must be created at one point on
        every rank. The default group is the caller's
        (`runtime.distributed.process_group`): this never creates one."""
        import torch.distributed as dist

        if axes == EMBED_GROUP:
            if self._groups is None or EMBED_GROUP not in self._groups:
                raise RuntimeError("the embedding group exists on a multi-stage mesh once "
                                   "create_groups ran")
            return self._groups[EMBED_GROUP]
        axes = self._check(axes)
        if self._groups is None and self.hosted:
            from galvatron_tpu_torch.runtime.distributed import backend_for, subgroup

            if not dist.is_initialized() or dist.get_world_size() != 1:
                raise RuntimeError("a hosted stage runs in a process of its own: it needs an "
                                   "initialized one-rank process group")
            self._groups = {(): subgroup((0,), backend_for(self.device))}
        if self._groups is None:
            if self.world_size != 1:
                raise RuntimeError("process groups of a %d-rank mesh must be created by "
                                   "create_groups on every rank before use" % self.world_size)
            if not dist.is_initialized():
                raise RuntimeError("the layout path needs an initialized process group, even "
                                   "at world size 1: run inside "
                                   "runtime.distributed.process_group(device)")
            self.create_groups()
        return self._groups[axes]


def build_mesh(config, rank: Optional[int] = None, device=None) -> RankMesh:
    """The rank grid of `config` for this process: `rank` defaults to the
    process group's rank (0 when none is initialized, which only a world of
    one allows). With an initialized process group the groups are created
    here, on every rank."""
    import torch.distributed as dist

    if rank is None:
        if dist.is_initialized():
            rank = dist.get_rank()
            if dist.get_world_size() != config.world_size:
                raise ValueError(
                    "the strategy's world size is %d but the process group has %d ranks"
                    % (config.world_size, dist.get_world_size()))
        elif config.world_size != 1:
            raise ValueError("world size %d needs an initialized process group: launch "
                             "with torchrun --nproc_per_node %d" % (config.world_size,
                                                                    config.world_size))
        else:
            rank = 0
    mesh = RankMesh(config, rank, device)
    if dist.is_initialized():
        mesh.create_groups()
    return mesh
