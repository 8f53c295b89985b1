"""Model construction and the train step under a per-layer strategy.

Port of ``galvatron_tpu/runtime/model_api.py``. The reference builds one
mesh, places every parameter by its ``PartitionSpec`` and jits a step whose
collectives XLA derives; here each rank of a ``torch.distributed`` world
(`runtime.distributed`) holds its shard of every parameter
(``models.base.model_param_layouts``), runs the forward and backward on its
rows of the global batch (`shard_batch`) and its shards, and calls the
collectives itself:

- ZeRO-3 layers gather their weights over their dp group at use and
  reduce-scatter the gradients (``models.base.gathered``);
- ZeRO-2 reduce-scatters each micro-batch's gradients over the layer's dp
  group into a sharded accumulator; the update runs on the shard and the
  parameter is all-gathered back;
- every other gradient is all-reduced over exactly the axes it is partial
  over: the layer's dp and cp axes, plus its tp axes for the parameters
  that are replicated over tp but saw sequence shards (every parameter of
  a Ulysses layer, the Megatron-SP-replicated ones);
- the loss is this rank's share of the global token mean, micro-batches
  weighted by their valid tokens across all ranks that hold other tokens
  (dp, and the sequence shards of vocab cp and vocab sp), as the
  reference.

A layer with cp > 1 runs ring attention over its cp group
(``ops/ring_attention.py``), a Ulysses layer two all-to-alls over its tp
group; under ``cp_mode="zigzag"`` the batch arrives permuted
(``runtime.dataloader.prepare_batch``) and `shard_batch` cuts each row's
sequence over the vocab layers' token axes.

Every collective runs even over a one-rank group, so a world of one drives
the same code. `check_layout` names what this slice does not execute.

Under a pipeline (``pp > 1``) each rank holds its stage's part of the model
(``models.base.stage_model``) and `loss_and_grads` runs the whole batch as
``chunks`` micro-batches through the stage schedule of ``pipeline_type``
(``parallel.pipeline``: GPipe; ``parallel.pipeline_1f1b``: 1F1B), as the
reference does; the reductions above stay within the stage, and whatever
crosses stages (activations, cotangents, the tied embedding's gradient
sum, the gradient norm, the guard's verdict, the loss) goes through the
model's transport. Without a pipeline the same path runs one stage, in the
1F1B order (each micro-batch's forward, then its backward).

The family's parameter tree comes from its model def (`model_def`:
``models.base.GenericDef`` for the generic transformer, ``models.t5.T5Def``
and ``models.swin.SwinDef`` for the families with their own trees): the
tree of a stage, its placements and runtime layouts, the stage body, the
shapes that cross each stage boundary (a tuple of tensors: T5's decoder
stages send the encoder output beside their state; Swin's shapes change at
each merge), and the parameters several stages hold, whose gradients are
summed over those stages (a tied table, T5's shared tables).

Params, gradients and Adam states are per-stage mappings, keyed by the
stage: one entry for a process that is one stage (``transport="p2p"``, or
no pipeline), every stage for a process that hosts them all
(``transport="local"``, each stage one device).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.models import base as M
from galvatron_tpu_torch.parallel import comm
from galvatron_tpu_torch.parallel import spec as S
from galvatron_tpu_torch.parallel import pipeline as PL
from galvatron_tpu_torch.parallel.mesh import RankMesh, build_mesh, vocab_axes
from galvatron_tpu_torch.parallel.pipeline_1f1b import one_f_one_b_order
from galvatron_tpu_torch.runtime.optimizer import AdamState, AdamW, moment_dim, moment_spec

def model_def(cfg, hp: HybridParallelConfig):
    """The family's view of its parameter tree for the layout path
    (``models.base.GenericDef``'s members): T5's and Swin's own trees, else
    the generic transformer's."""
    from galvatron_tpu_torch.models import swin, t5

    if isinstance(cfg, t5.T5Config):
        return t5.T5Def(cfg, hp)
    if isinstance(cfg, swin.SwinConfig):
        return swin.SwinDef(cfg, hp)
    return M.GenericDef(cfg, hp)


def check_layout(hp: HybridParallelConfig, mode: str = "train", cfg=None) -> None:
    """Raise ValueError unless this slice executes `hp`: in train mode any
    world size with per-layer DP / ZeRO-2/3 / Megatron TP(+SP) / Ulysses /
    ring cp / vocab TP, sp and cp, and GPipe or 1F1B pipelines within the
    reference's contracts, and what the family of `cfg` refuses
    (``analysis.strategy_lint.train_refusals``); in serve mode any world
    size with per-layer dp, ZeRO-2/3 (the params' layout), tp with or
    without ``tp_consec`` and vocab tp, on one stage, without cp or
    Ulysses (GLS014, as the serve lint) and without vocab sp or vocab cp
    (a decode step's one token has no sequence to shard)."""
    from galvatron_tpu_torch.analysis.strategy_lint import train_refusals

    if mode == "serve":
        problems = []
        if hp.pp > 1:
            problems.append("pp=%d: serving runs one stage (GLS014)" % hp.pp)
        problems += ["layer %d: cp=%d (GLS014)" % (i, s.cp) for i, s in enumerate(hp.layers)
                     if s.cp > 1][:1]
        problems += ["layer %d: Ulysses sp (GLS014)" % i for i, s in enumerate(hp.layers)
                     if s.sp][:1]
        if hp.vocab_sp or hp.vocab_cp > 1:
            problems.append("vocab_sp=%d vocab_cp=%d: the vocab layers of a decode step shard "
                            "no sequence" % (hp.vocab_sp, hp.vocab_cp))
        if hp.tp_comm_mode != "gspmd" and any(s.tp > 1 for s in hp.layers):
            problems.append("tp_comm_mode=%r (manual TP overlap: ROADMAP queue 1 item 10)"
                            % hp.tp_comm_mode)
        if problems:
            raise ValueError("galvatron_tpu_torch does not serve this strategy: %s"
                             % "; ".join(problems))
        return
    problems = train_refusals(hp, cfg)
    if problems:
        raise ValueError("galvatron_tpu_torch does not execute this strategy yet: %s"
                         % "; ".join(problems))


def _set_param(model: nn.Module, name: str, tensor: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    model.get_submodule(owner)._parameters[leaf] = nn.Parameter(tensor)


@dataclass
class HybridParallelModel:
    cfg: M.TransformerConfig
    hp: HybridParallelConfig
    device: torch.device
    mesh: RankMesh
    param_layouts: Dict[str, M.ParamLayout]
    arch: M.GenericDef = None  # the family's tree (`model_def`)
    transport: Optional[PL.Transport] = None  # default: this rank's stage, point to point
    stage_meshes: Dict[int, RankMesh] = field(default_factory=dict)
    _layouts: Dict[int, M.ModelLayouts] = field(default_factory=dict, repr=False)
    _grad_spec_cache: Optional[Dict[str, S.Spec]] = field(default=None, repr=False)
    _shape_cache: Optional[Dict[str, Tuple[int, ...]]] = field(default=None, repr=False)

    def __post_init__(self):
        if not self.stage_meshes:
            self.stage_meshes = {self.mesh.stage: self.mesh}
        if self.arch is None:
            self.arch = model_def(self.cfg, self.hp)
        if self.transport is None:
            self.transport = PL.P2PTransport(self.mesh)

    # --------------------------------------------------------------- stages
    @property
    def stages(self) -> Tuple[int, ...]:
        """The pipeline stages this process hosts: its own (one), or every
        stage under a `LocalTransport`."""
        return tuple(sorted(self.stage_meshes))

    def _copy(self, name: str, stage: int) -> bool:
        """True for a stage's copy of a parameter that an earlier stage
        also holds (a tied table's last-stage copy, T5's shared tables)."""
        holders = self.arch.shared().get(name)
        return holders is not None and stage != holders[0]

    # -------------------------------------------------------------- layouts
    def layouts_of(self, stage: int) -> M.ModelLayouts:
        """Per-layer runtime layouts of a hosted stage (process groups;
        built at first use)."""
        if stage not in self._layouts:
            self._layouts[stage] = self.arch.build_layouts(self.stage_meshes[stage])
        return self._layouts[stage]

    @property
    def layouts(self) -> M.ModelLayouts:
        """The layouts of this process's (first hosted) stage."""
        return self.layouts_of(self.stages[0])

    def _dp_size(self, name: str) -> int:
        return self.mesh.size(self.param_layouts[name].dp)

    def moment_dim(self, name: str, shape) -> Optional[int]:
        """The dim ZeRO-2 shards the moments of `name` over (None: none);
        `shape` may be a shard's, the dim is found among unsharded dims."""
        pl = self.param_layouts[name]
        return moment_dim(pl.spec, shape, self._dp_size(name), pl.zero_opt, pl.z3_dim is not None)

    def zero_axes_tree(self) -> Dict[str, Tuple[str, ...]]:
        """Per parameter, the dp axes its Adam moments shard over (ZeRO)."""
        return {n: pl.dp if pl.zero_opt else () for n, pl in self.param_layouts.items()}

    def grad_accum_specs(self) -> Dict[str, S.Spec]:
        """Per parameter, the placement of its accumulated gradient and of
        its Adam moments: dp-sharded wherever ZeRO-2 applies."""
        if self._grad_spec_cache is None:
            self._grad_spec_cache = {
                n: moment_spec(self.param_layouts[n].spec, p.dim(), self.moment_dim(n, p.shape),
                               self.param_layouts[n].dp)
                for n, p in self.arch.tree("meta").named_parameters()}
        return self._grad_spec_cache

    # --------------------------------------------------------------- params
    def _shard(self, name: str, full: torch.Tensor, stage: int) -> torch.Tensor:
        t = S.shard_tensor(full, self.param_layouts[name].spec, self.stage_meshes[stage])
        return t if t.shape == full.shape else t.clone()

    def _meta_model(self, stage: int) -> nn.Module:
        return self.arch.tree("meta", stage if self.hp.pp > 1 else None)

    def init_params(self, seed: int) -> Dict[int, nn.Module]:
        """This process's parameters on `self.device`, per hosted stage.
        Each parameter is drawn in full from a torch.Generator seeded with
        `seed` (in the order of the family's whole tree: for the generic
        family ``models.base.init_model_params``'s, so a world of one gets
        its exact weights) and sliced; a stage keeps the parameters it
        holds, so every world size and pipeline division starts from the
        same weights."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        models = {s: self._meta_model(s) for s in self.stages}
        held = {s: dict(m.named_parameters()) for s, m in models.items()}
        with torch.no_grad():
            for name, p in self.arch.tree("meta").named_parameters():
                full = torch.empty(p.shape, dtype=self.cfg.param_dtype, device=self.device)
                self.arch.init_param_(name, full, gen)
                holders = [s for s in self.stages if name in held[s]]
                for k, s in enumerate(holders):
                    t = self._shard(name, full, s)
                    _set_param(models[s], name, t.clone() if k else t)
        return models

    def empty_params(self) -> Dict[int, nn.Module]:
        """This process's parameter shards, per hosted stage, uninitialized
        (a checkpoint restore fills them in place)."""
        out = {}
        for s in self.stages:
            model = self._meta_model(s)
            for name, p in list(model.named_parameters()):
                shape = S.local_shape(p.shape, self.param_layouts[name].spec,
                                      self.stage_meshes[s], name)
                _set_param(model, name, torch.empty(shape, dtype=self.cfg.param_dtype,
                                                    device=self.device))
            out[s] = model
        return out

    def shard_params(self, full: Dict[str, torch.Tensor]) -> Dict[int, nn.Module]:
        """This process's parameters, per hosted stage, from a full state
        dict (e.g. the JAX tree through ``tools.from_jax.params_from_numpy``)."""
        out = {}
        for s in self.stages:
            model = self._meta_model(s)
            for name, _ in list(model.named_parameters()):
                t = full[name].to(device=self.device, dtype=self.cfg.param_dtype)
                _set_param(model, name, self._shard(name, t, s).clone())
            out[s] = model
        return out

    def _gather_stages(self, per_stage: Dict[int, Dict[str, torch.Tensor]],
                       specs: Dict[str, S.Spec]) -> Dict[str, torch.Tensor]:
        """The full tensors of every stage from each hosted stage's shards
        (collective over the stage, then over the pipeline)."""
        mine = {s: {n: S.gather_tensor(t, specs[n], self.stage_meshes[s]) for n, t in d.items()}
                for s, d in per_stage.items()}
        out: Dict[str, torch.Tensor] = {}
        for d in self.transport.gather(mine):
            for n, t in d.items():
                out.setdefault(n, t.to(self.device))
        return out

    def gather_leaf(self, per_stage: Dict[int, Dict[str, torch.Tensor]], name: str,
                    spec: S.Spec, host: bool = True) -> torch.Tensor:
        """One full tensor, on the host (or, without `host`, on this
        process's device), from the shards of `name` in the hosted stages'
        dicts (collective, like `_gather_stages`, but one leaf's worth of
        device memory at a time)."""
        mine = {s: {name: S.gather_tensor(d[name], spec, self.stage_meshes[s])}
                if name in d else {} for s, d in per_stage.items()}
        full = next(d[name] for d in self.transport.gather(mine) if name in d)
        return full.cpu() if host else full.to(self.device)

    def gather_params(self, params: Dict[int, nn.Module]) -> Dict[str, torch.Tensor]:
        """The full state dict from every rank's shards (collective)."""
        specs = {n: pl.spec for n, pl in self.param_layouts.items()}
        return self._gather_stages({s: dict(m.named_parameters()) for s, m in params.items()},
                                   specs)

    # ---------------------------------------------------------------- batch
    def shard_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's tokens of the global batch: for each of the
        ``chunks`` micro-batches, its shard over the vocab layers' dp axes
        (the first layout the activations take), micro-batch after
        micro-batch, and of each (B, S) field's rows their sequence shard
        over the vocab layers' token axes (vocab cp, plus vocab tp under
        vocab sp; the vocab-parallel embedding and loss read the whole cp
        shard). Pixels and rank-1 labels shard over the rows only (the
        reference's ``_batch_spec_for``)."""
        vax = vocab_axes(self.hp)
        n, i = self.mesh.size(vax.dp), self.mesh.index(vax.dp)
        seq_axes = S.token_seq_axes(vax)
        m, j = self.mesh.size(seq_axes), self.mesh.shard_index(seq_axes)
        chunks = self.hp.chunks
        out = {}
        for k, v in batch.items():
            b = v.shape[0]
            if b % (chunks * n):
                raise ValueError("batch of %d rows does not split into %d micro-batches over "
                                 "%d dp ranks" % (b, chunks, n))
            rest = tuple(v.shape[1:])
            v = v.reshape((chunks, n, b // (chunks * n)) + rest)[:, i].reshape((b // n,) + rest)
            if m > 1 and v.dim() == 2:
                if v.shape[1] % m:
                    raise ValueError("%s: sequence of %d does not split over %d vocab sequence "
                                     "shards (GLS008)" % (k, v.shape[1], m))
                v = v.chunk(m, 1)[j]
            out[k] = v
        return out

    # ------------------------------------------------------------ loss, grads
    def _micro_batches(self, batch: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
        local = self.shard_batch(batch)
        chunks = self.hp.chunks
        return [{k: v.chunk(chunks)[c] for k, v in local.items()} for c in range(chunks)]

    def _mb_weights(self, mbs, layouts: M.ModelLayouts) -> torch.Tensor:
        """Each micro-batch loss is a mean over its own valid tokens (of
        every rank of the token group): weight it by its share of the
        step's valid tokens, so the chunked objective equals the chunks ==
        1 one."""
        if "loss_mask" in mbs[0]:
            sums = torch.stack([mb["loss_mask"].float().sum() for mb in mbs])
            sums = comm.all_reduce(sums, layouts.vocab.token_group)
            return sums / sums.sum().clamp(min=1.0)
        return torch.full((len(mbs),), 1.0 / len(mbs), device=self.device)

    def _zero2_dims(self, module: nn.Module) -> Dict[str, int]:
        dims = {n: self.moment_dim(n, p.shape) for n, p in module.named_parameters()}
        return {n: d for n, d in dims.items() if d is not None}

    def _accumulate_zero2(self, named, zero2, acc, mesh: RankMesh) -> None:
        """ZeRO-2: one micro-batch's gradient into the sharded accumulator."""
        for n, d in zero2.items():
            p = named[n]
            shard = comm.reduce_scatter(p.grad, d, mesh.group_for(self.param_layouts[n].dp))
            acc[n] = shard if n not in acc else acc[n].add_(shard)
            p.grad = None

    def _synced_grads(self, named, zero2, acc, mesh: RankMesh) -> Dict[str, torch.Tensor]:
        """Each gradient summed over the axes it is partial over."""
        grads = {}
        for n, p in named.items():
            pl = self.param_layouts[n]
            if n in zero2 or pl.z3_dim is not None:
                # the dp sum happened in the reduce-scatter
                g = acc[n] if n in zero2 else p.grad
                axes = tuple(a for a in pl.partial if a not in pl.dp)
                if axes:
                    torch.distributed.all_reduce(g, group=mesh.group_for(axes))
            else:
                g = p.grad
                torch.distributed.all_reduce(g, group=mesh.group_for(pl.partial))
            grads[n] = g
        return grads

    def _schedule(self, stage: int, backward: bool) -> List[PL.Step]:
        """The stage's order: 1F1B under ``pipedream_flush`` and without a
        pipeline (each micro-batch's forward, then its backward), else
        GPipe (every forward, then every backward; forwards only for
        eval)."""
        pp, chunks = self.hp.pp, self.hp.chunks
        if backward and (self.hp.pipeline_type == "pipedream_flush" or pp == 1):
            return one_f_one_b_order(pp, chunks, stage)
        return PL.gpipe_order(pp, chunks, stage, backward)

    def _run_pipeline(self, params: Dict[int, nn.Module], batch: Dict[str, torch.Tensor],
                      backward: bool):
        """Every micro-batch of `batch` through the stage schedules (with
        `backward`, each stage's ZeRO-2 accumulation after each backward).
        Returns the loss, broadcast from the last stage, and per hosted
        stage (named params, ZeRO-2 dims, ZeRO-2 accumulators)."""
        mbs = self._micro_batches(batch)
        last = self.hp.pp - 1
        runners = {s: PL.StageRunner(s, self.arch.stage_body(s, m, self.layouts_of(s)), self.hp)
                   for s, m in params.items()}
        weights = self._mb_weights(mbs, self.layouts_of(last)) if last in runners else None
        state = {}
        for s, m in params.items():
            if backward:
                for p in m.parameters():
                    p.grad = None
            state[s] = (dict(m.named_parameters()), self._zero2_dims(m), {})

        def forward(s, mb, x_in):
            return runners[s].forward(mb, mbs[mb], x_in, weights[mb] if s == last else None)

        def backward_fn(s, mb, grad):
            out = runners[s].backward(mb, grad)
            named, zero2, acc = state[s]
            self._accumulate_zero2(named, zero2, acc, self.stage_meshes[s])
            return out

        self.transport.run({s: self._schedule(s, backward) for s in params}, forward,
                           backward_fn, self.arch.boundary(mbs, self.mesh))
        losses = {s: comm.all_reduce(r.loss, self.layouts_of(s).vocab.token_group) if s == last
                  else torch.zeros((), device=self.device) for s, r in runners.items()}
        return self.transport.from_last(losses)[self.stages[0]], state

    def loss_and_grads(self, params: Dict[int, nn.Module], batch: Dict[str, torch.Tensor]):
        """(loss, grads) of the GLOBAL batch: the reference's loss over all
        rows, and per hosted stage, per parameter its synced gradient in the
        placement of `grad_accum_specs` (this rank's shard)."""
        loss, state = self._run_pipeline(params, batch, backward=True)
        grads = {s: self._synced_grads(named, zero2, acc, self.stage_meshes[s])
                 for s, (named, zero2, acc) in state.items()}
        specs = self.grad_accum_specs()
        for name, holders in self.arch.shared().items():
            out = self.transport.sum_shared({s: grads[s][name] for s in grads if s in holders},
                                            holders, self._like(name, specs[name]))
            for s, g in out.items():
                grads[s][name] = g
        return loss, grads

    def _like(self, name: str, spec: S.Spec):
        """(shape, dtype) of this rank's shard of `name` placed as `spec`."""
        shape = self._full_shapes()[name]
        return S.local_shape(shape, spec, self.mesh, name), self.cfg.param_dtype

    def _full_shapes(self) -> Dict[str, Tuple[int, ...]]:
        if self._shape_cache is None:
            self._shape_cache = {n: tuple(p.shape)
                                 for n, p in self.arch.tree("meta").named_parameters()}
        return self._shape_cache

    def _world_max(self, t: torch.Tensor) -> torch.Tensor:
        """The max of `t` over every rank: over the stage, then the stages."""
        t = comm.all_reduce(t, self.mesh.group_for(self.mesh.names[1:]),
                            op=torch.distributed.ReduceOp.MAX)
        return self.transport.reduce({s: t for s in self.stages}, "max")[self.stages[0]]

    def grad_sumsq(self, grads) -> torch.Tensor:
        """The global sum of squares of sharded gradients, every element
        counted once: each rank's shard sum is divided by the number of
        ranks of its stage that hold the same shard and summed over the
        stage, then over the stages (without the last stage's copy of a
        tied table)."""
        specs = self.grad_accum_specs()
        per_stage = self.mesh.world_size // self.hp.pp
        totals = {}
        for s, stage_grads in grads.items():
            mesh = self.stage_meshes[s]
            total = torch.zeros((), dtype=torch.float32, device=self.device)
            for n, g in stage_grads.items():
                if self._copy(n, s):
                    continue
                axes = sorted({a for ax in specs[n] for a in ax}, key=mesh.names.index)
                total = total + g.float().pow(2).sum() / (per_stage // mesh.size(axes))
            totals[s] = comm.all_reduce(total, mesh.group_for(mesh.names[1:]))
        return self.transport.reduce(totals)[self.stages[0]]

    def gather_grads(self, grads) -> Dict[str, torch.Tensor]:
        """Full gradients from every rank's shards (collective)."""
        return self._gather_stages(grads, self.grad_accum_specs())

    # ------------------------------------------------------------ optimizer
    def init_opt_state(self, tx: AdamW, params: Dict[int, nn.Module]) -> Dict[int, AdamState]:
        """Zero moments in the placement of `grad_accum_specs`, per hosted
        stage."""
        out = {}
        for s, m in params.items():
            shapes = {}
            for n, p in m.named_parameters():
                d = self.moment_dim(n, p.shape)
                shapes[n] = p.shape if d is None else \
                    p.shape[:d] + (p.shape[d] // self._dp_size(n),) + p.shape[d + 1:]
            out[s] = AdamState(
                count=0,
                mu={n: torch.zeros(shape, dtype=self.cfg.param_dtype, device=self.device)
                    for n, shape in shapes.items()},
                nu={n: torch.zeros(shape, dtype=self.cfg.param_dtype, device=self.device)
                    for n, shape in shapes.items()})
        return out

    def gather_opt_state(self, state: Dict[int, AdamState]) -> AdamState:
        """Full moments from every rank's shards (collective)."""
        specs = self.grad_accum_specs()
        return AdamState(count=state[self.stages[0]].count,
                         mu=self._gather_stages({s: st.mu for s, st in state.items()}, specs),
                         nu=self._gather_stages({s: st.nu for s, st in state.items()}, specs))

    # ---------------------------------------------------------- checkpoints
    def checkpoint_view(self, params: Dict[int, nn.Module],
                        opt_state: Optional[Dict[int, AdamState]] = None):
        """What this rank's checkpoint file holds of its stage's state: all
        of it, but a stage's copy of a shared parameter (the last stage's
        copy of a tied table, T5's shared tables) and of its moments (the
        first holder saves them once; `restore_tied` refills the copies
        after a load). Returns (module, AdamState) or name -> tensor views;
        a rank file holds one stage, so a process that hosts every stage
        has none."""
        if len(params) != 1:
            raise ValueError("a checkpoint holds one stage per rank; this process hosts "
                             "stages %s (save them with checkpoint_views)" % sorted(params))
        return next(iter(self.checkpoint_views(params, opt_state).values()))

    def checkpoint_views(self, params: Dict[int, nn.Module],
                         opt_state: Optional[Dict[int, AdamState]] = None):
        """`checkpoint_view` of every hosted stage, keyed by the strategy
        rank whose file holds it (the stage mesh's rank: this process's
        rank, or under a `LocalTransport` the stage's index), for
        ``save_checkpoint(..., rank_views=)``."""
        out = {}
        for s, module in params.items():
            state = opt_state[s] if opt_state is not None else None
            copies = {n for n in self.arch.shared() if self._copy(n, s)}
            if not copies:
                out[self.stage_meshes[s].rank] = (module, state)
                continue
            view = {n: p for n, p in module.named_parameters() if n not in copies}
            out[self.stage_meshes[s].rank] = (view, None if state is None else AdamState(
                count=state.count, mu={n: t for n, t in state.mu.items() if n not in copies},
                nu={n: t for n, t in state.nu.items() if n not in copies}))
        return out

    def restore_tied(self, params: Dict[int, nn.Module], opt_state: Dict[int, AdamState],
                     loaded: AdamState) -> None:
        """After a load into `checkpoint_view`'s views (`loaded`: the Adam
        state view): the Adam count from the view, and under a pipeline the
        copies of each shared parameter, and of its moments, from the first
        holder's (collective over the holders)."""
        for st in opt_state.values():
            st.count = loaded.count
        specs = self.grad_accum_specs()
        for name, holders in self.arch.shared().items():
            hosted = [s for s in params if s in holders]
            tensors = {s: [dict(params[s].named_parameters())[name].data,
                           opt_state[s].mu[name], opt_state[s].nu[name]] for s in hosted}
            likes = [self._like(name, self.param_layouts[name].spec)] + [
                self._like(name, specs[name])] * 2
            for k in range(3):
                self.transport.copy_shared({s: ts[k] for s, ts in tensors.items()}, holders,
                                           likes[k])

    def eval_loss(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The loss of the GLOBAL batch, forward only (the reference's
        ``eval_loss``), under ``torch.no_grad`` (no residuals kept, no
        backward kernel): this rank's tokens in one forward, the shares
        summed over the vocab layers' token group; under a pipeline, the forward-only
        GPipe schedule over ``chunks`` micro-batches weighted by their valid
        tokens (the reference's ``make_pipelined_loss``), the last stage's
        loss on every stage."""
        with torch.no_grad():
            if self.hp.pp > 1:
                return self._run_pipeline(params, batch, backward=False)[0]
            loss = self.arch.loss(params[0], self.shard_batch(batch), self.layouts)
            return comm.all_reduce(loss, self.layouts.vocab.token_group)

    def make_train_step(self, tx: AdamW, *, guard_anomalies: bool = False,
                        sdc_check: str = "off") -> Callable:
        """The (params, opt_state, batch) -> (params, opt_state, metrics)
        step on the GLOBAL batch (every rank passes the same one); params
        and opt_state are this process's shards per hosted stage, updated in
        place and returned. metrics = {"loss",
        "grad_norm"}: the step's loss and the global norm of the accumulated
        gradients before clipping, as device scalars, the same on every
        stage.

        With `guard_anomalies` the step takes a fourth argument, the spike
        cap (default +inf), and reports ``metrics["anomalous"]``: a step
        whose loss or gradient norm is non-finite, or whose loss exceeds the
        cap, applies nothing — params, both Adam moments, the ZeRO-2 shards
        and the Adam count stay bitwise as they were (the reference's
        keep-old select). The verdict is max-reduced over the world so every
        rank takes it, then read on the host in one transfer with the
        gradient norm, which the clip uses: the guarded step syncs once, as
        the unguarded one does for the clip. Each stage updates its own
        parameters; a tied table's two copies get the same gradient, so they
        stay bitwise equal.

        `sdc_check` (``runtime/sdc.py``) adds the silent-corruption
        sentinel's side outputs. "digest": ``metrics["sdc_fold"]``, the
        layout-invariant fold and sum of squares of the params the step
        hands back (float64 [fold sum, sumsq], one fold-kernel launch per
        step and one all-reduce; ``sdc.fold_value`` reads it), a pure side
        output: the trajectory is bitwise that of a run without it. "vote"
        (pure-dp layouts, `sdc.vote_reason`; callers downgrade to "digest"
        elsewhere) also folds every rank's whole replica of the INPUT params
        and all-gathers the folds over the dp group before the step
        (``metrics["sdc_votes"]``, in ``sdc.vote_device_ids`` order); on any
        disagreement (``metrics["sdc_mismatch"]``) the step applies nothing,
        through the guard's keep-old path, so a lying replica cannot ride
        the summed gradients onto every rank. The votes are read in the
        guard's one host transfer. The quantized gradient sync is refused
        until its slice is ported."""
        from galvatron_tpu_torch.runtime import sdc as SDC

        if sdc_check not in SDC.SDC_MODES:
            raise ValueError("sdc_check must be one of %r, got %r" % (SDC.SDC_MODES, sdc_check))
        vote_fn = None
        if sdc_check == "vote":
            reason = SDC.vote_reason(self.hp)
            if reason is not None:
                raise ValueError("sdc_check='vote' unsupported for this layout (%s); callers "
                                 "should downgrade to 'digest'" % reason)
            vote_fn = SDC.make_vote_digest_fn(self)
        if any(s.grad_comm_dtype != "none" or s.param_comm_dtype != "none"
               for s in self.hp.layers):
            raise ValueError("quantized gradient/parameter sync is not ported yet: the "
                             "data-parallel slice syncs in full precision; quantized "
                             "collectives come with ROADMAP queue 1 item 10")

        def keep_old(params, opt_state, metrics):
            for m in params.values():
                for p in m.parameters():
                    p.grad = None
            if sdc_check != "off":
                metrics["sdc_fold"] = SDC.state_fold_metrics(self, params)
            return params, opt_state, metrics

        def train_step(params, opt_state, batch, spike_cap=float("inf")):
            votes = vote_fn(params) if vote_fn is not None else None
            loss, grads = self.loss_and_grads(params, batch)
            grad_norm = self.grad_sumsq(grads).sqrt()
            metrics = {"loss": loss, "grad_norm": grad_norm}
            norm_value = None
            if guard_anomalies or votes is not None:
                # one host transfer: the guard's verdict, the norm the clip
                # uses and the replica votes
                row = [grad_norm.float().reshape(1)]
                if guard_anomalies:
                    bad = self._world_max((~torch.isfinite(loss) | ~torch.isfinite(grad_norm)
                                           | (loss > spike_cap)).float())
                    row.append(bad.reshape(1))
                if votes is not None:
                    row.append(votes.to(grad_norm.device))
                host = torch.cat([r.to(torch.float64) for r in row]).tolist()
                norm_value = host[0]
                if guard_anomalies:
                    metrics["anomalous"] = host[1] > 0
                if votes is not None:
                    metrics["sdc_votes"] = [int(v) for v in host[-votes.numel():]]
                    metrics["sdc_mismatch"] = len(set(metrics["sdc_votes"])) > 1
                if metrics.get("anomalous") or metrics.get("sdc_mismatch"):
                    return keep_old(params, opt_state, metrics)
            elif len(params) > 1:
                norm_value = float(grad_norm)  # one host read for every stage's clip
            for s, m in params.items():
                mesh = self.stage_meshes[s]
                targets, zero2 = {}, {}
                for n, p in m.named_parameters():
                    d = self.moment_dim(n, p.shape)
                    if d is None:
                        targets[n] = p
                    else:
                        dp = self.param_layouts[n].dp
                        targets[n] = p.data.chunk(self._dp_size(n), d)[mesh.index(dp)]
                        zero2[n] = (p, d, mesh.group_for(dp))
                tx.update(targets, grads[s], opt_state[s], grad_norm=grad_norm,
                          grad_norm_value=norm_value)
                with torch.no_grad():
                    for n, (p, d, group) in zero2.items():
                        p.data.copy_(comm.all_gather(targets[n], d, group))
                for p in m.parameters():
                    p.grad = None
            if sdc_check != "off":
                # the fold of the params this step hands back: a side output
                metrics["sdc_fold"] = SDC.state_fold_metrics(self, params)
            return params, opt_state, metrics

        return train_step


def construct_hybrid_parallel_model(
    cfg: M.TransformerConfig,
    hp: HybridParallelConfig,
    device,
    mode: str = "train",
    transport: str = "p2p",
) -> HybridParallelModel:
    """The model of `hp` for this rank. With more than one rank, call it on
    every rank at the same point: it creates the process groups. `transport` is
    "p2p" (one stage per process, the process group's ranks; what ``cli
    train`` runs) or "local" (under a pipeline, this process hosts every
    stage of a strategy whose stages hold one device each, in a one-rank
    process group)."""
    check_layout(hp, mode, cfg)
    device = torch.device(device)
    arch = model_def(cfg, hp)
    layouts = arch.param_layouts()
    if transport not in ("p2p", "local"):
        raise ValueError("transport %r: 'p2p' or 'local'" % transport)
    if hp.pp > 1 and transport == "local":
        meshes = {s: RankMesh.hosted_stage(hp, s, device) for s in range(hp.pp)}
        return HybridParallelModel(cfg=cfg, hp=hp, device=device, mesh=meshes[0],
                                   param_layouts=layouts, transport=PL.LocalTransport(hp.pp),
                                   stage_meshes=meshes, arch=arch)
    mesh = build_mesh(hp, device=device)
    return HybridParallelModel(cfg=cfg, hp=hp, device=device, mesh=mesh, param_layouts=layouts,
                               arch=arch)
