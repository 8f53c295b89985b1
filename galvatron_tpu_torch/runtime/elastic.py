"""Elastic resume and live migration: re-plan the strategy for the world a
run resumes or goes on in.

Port of ``galvatron_tpu/runtime/elastic.py``. Every
checkpoint's manifest carries a provenance block
(``runtime/provenance.build_provenance``: the strategy JSON, the world
size, the model and optimizer digests, the memory budget). On ``--load``
with ``--elastic resume|search`` the train CLI calls
`resolve_resume_strategy`, which

1. reads the provenance of the newest intact step (or ``--load_iteration``);
2. refuses, with the reference's GLS2xx diagnostics (exit code 2 at the
   CLI), a checkpoint it cannot resume safely: another model (GLS201), no
   provenance (GLS204), a changed world with no way to pick a strategy
   (GLS205), or no strategy that fits the budget (GLS203), and, for a
   family that builds its own tree (T5, Swin), a strategy of another
   pipeline layout (GLS207, as the reference's migration refuses it);
3. on an unchanged world without ``--elastic_strategy`` returns the SAVED
   strategy (action "match"): the restore is the plain, bitwise one;
4. otherwise takes the ``--elastic_strategy`` JSON (its analytic stage
   memory held to the budget: GLS203), or, under ``search``, re-runs the
   strategy search (``search/engine.py``) for the live world under the
   same global batch and budget, on the profiled tables of
   ``--config_dir`` when it has them for this model and on analytic tables
   (`analytic_model_profiles`, `analytic_hardware_profiles`) otherwise.

The restore across strategies is ``runtime/checkpoint.load_checkpoint(...,
target=, allow_cross=True)``: every rank fills its shards of the new layout from the saved
ranks' files.

Live migration (`resolve_migration_strategy`, `migrate`) moves a running
state onto another strategy, and off ranks that leave, in memory: the
train driver calls it at a drained step boundary on SIGUSR1, on a degraded
mesh probe under ``--migrate_on_degrade`` (the detection is
``runtime/health.py``), on a silent-corruption quarantine
(``runtime/sdc.py``) and on an autotune swap (``runtime/autotune.py``).

The serve half (`search_surviving_serve_strategy`,
`resolve_serve_migration_strategy`, `migrate_serve_params`) re-plans a
live server for the ranks that survive a degraded mesh: a fresh
``--objective serve`` search (or ``--elastic_strategy``), the params moved
in memory by `migrate` without an optimizer state; ``cli serve`` then
rebuilds the engine and journal-replays the in-flight requests
(``serve/engine.ContinuousBatcher.migrate_to``). A world that cannot serve
refuses with GLS015.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from galvatron_tpu_torch.analysis import diagnostics as D
from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.obs import telemetry
from galvatron_tpu_torch.runtime.provenance import model_config_digest, optimizer_digest

DEFAULT_MEMORY_GB = 16.0  # the search CLI's --memory_constraint default


# ------------------------------------------------------ analytic cost tables
def analytic_model_profiles(model_cfg: Any, max_tp: int) -> Optional[Tuple[dict, dict]]:
    """(time_config, memory_config) for the search engine from the model
    config alone: the no-profiles fallback, on the analytic parameter and
    activation tables of ``analysis/strategy_lint.py``. The time is a
    flops-proportional constant: without profiles every strategy's compute
    scales alike, so the DP's comparisons stay meaningful."""
    from galvatron_tpu_torch.analysis.strategy_lint import (
        _analytic_activation_dict,
        _analytic_parameter_mb,
    )

    param_mb = _analytic_parameter_mb(model_cfg)
    act = _analytic_activation_dict(model_cfg, max_tp)
    if param_mb is None or not act:
        return None
    h = getattr(model_cfg, "hidden_size", 1024)
    s = getattr(model_cfg, "max_seq_len", 2048)
    # ~12*s*h^2 flops/token forward; a fixed throughput turns it into
    # ms/layer/sample (only ratios matter without profiles)
    fwd_ms = 12.0 * s * h * h / 1e12 * 1e3
    time_config = {"layertype_0": max(fwd_ms, 1e-3), "other_time": max(fwd_ms, 1e-3)}
    states = {}
    t = 1
    while t <= max_tp:
        # embed/head model states (params + grads + Adam moments, ~16 bytes
        # per fp32 parameter) sharded over vocab tp
        vocab = getattr(model_cfg, "vocab_size", 0) or 0
        states[t] = vocab * h * 16.0 / 2**20 / t
        t *= 2
    act_other = {k: v for k, v in act.items() if k != "checkpoint"}
    memory_config = {
        "layertype_0": {
            "parameter_size": param_mb,
            "tp_activation_per_bsz_dict": dict(act),
        },
        "other_memory_pp_off": {"model_states": dict(states), "activation": dict(act_other)},
        "other_memory_pp_on": {
            "first_stage": {"model_states": {k: v / 2 for k, v in states.items()},
                            "activation": {k: v / 2 for k, v in act_other.items()}},
            "last_stage": {"model_states": {k: v / 2 for k, v in states.items()},
                           "activation": {k: v / 2 for k, v in act_other.items()}},
        },
    }
    return time_config, memory_config


def analytic_hardware_profiles(world: int) -> Tuple[dict, dict, dict]:
    """(allreduce, p2p, overlap) coefficient tables for the no-profiles
    fallback: flat bandwidths, so the search ranks strategies by
    communication volume."""
    allreduce = {}
    size = 2
    while size <= world:
        allreduce["allreduce_size_%d_consec_1" % size] = 100.0
        allreduce["allreduce_size_%d_consec_0" % size] = 80.0
        size *= 2
    p2p = {}
    size = 2
    while size <= world:
        p2p["pp_size_%d" % size] = 120.0
        size *= 2
    return allreduce, p2p, {"overlap_coe": 1.1}


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def search_surviving_strategy(
    model_cfg: Any,
    live_world: int,
    global_bsz: int,
    memory_budget_gb: float,
    model_type: str = "model",
    config_dir: Optional[str] = None,
    default_dp_type: str = "ddp",
    logger=None,
    time_config: Optional[dict] = None,
    memory_config: Optional[dict] = None,
    remat_search: bool = False,
) -> Optional[HybridParallelConfig]:
    """The strategy search for `live_world` devices under the same global
    batch and memory budget: on `config_dir`'s profiled tables for this
    model when it has them, else on the analytic tables. Explicit
    `time_config` / `memory_config` (the profiler's schema) override both:
    the online autotuner re-searches on MEASURED tables through this recipe,
    the global batch pinned. `remat_search` adds the per-layer remat axis
    (with chunks free, memory freed by remat may buy fewer micro-batches);
    `logger` is the engine's per-task logger. None when nothing fits (the
    caller's GLS203)."""
    from galvatron_tpu_torch.search.engine import SearchArgs

    num_layers = getattr(model_cfg, "num_layers", 1)
    args = SearchArgs(
        memory_constraint=memory_budget_gb,
        settle_bsz=global_bsz,  # the batch is part of the training trajectory
        settle_chunk=None,
        max_tp_deg=_max_tp(model_cfg, live_world),
        max_pp_deg=min(_pow2_floor(num_layers), live_world),
        default_dp_type=default_dp_type,
        sp_space="tp",
        remat_search=remat_search,
    )
    engine = _search_engine(args, model_cfg, live_world, model_type, config_dir, logger,
                            time_config, memory_config)
    if engine is None:
        return None
    result = engine.parallelism_optimization()
    if result is None:
        return None
    return engine.result_to_config(result)


def _max_tp(model_cfg: Any, live_world: int) -> int:
    """tp at most the largest power of two dividing the head count, so every
    plan passes the model-aware GLS007 check."""
    heads = getattr(model_cfg, "num_heads", None) or 1
    max_tp = 1
    while max_tp * 2 <= min(heads, live_world) and heads % (max_tp * 2) == 0:
        max_tp *= 2
    return max_tp


def _search_engine(args, model_cfg: Any, live_world: int, model_type: str,
                   config_dir: Optional[str], logger, time_config: Optional[dict] = None,
                   memory_config: Optional[dict] = None):
    """The search engine for `live_world` devices with its tables set: on
    `config_dir`'s profiled tables for this model when it has them, else on
    the analytic tables; explicit `time_config` / `memory_config` win. None
    when no table can be had (the analytic ones need the model's sizes)."""
    from galvatron_tpu_torch.search.engine import GalvatronSearchEngine

    engine = GalvatronSearchEngine(
        args, live_world,
        [{"hidden_size": getattr(model_cfg, "hidden_size", 1024),
          "seq_len": getattr(model_cfg, "max_seq_len", 2048),
          "layer_num": getattr(model_cfg, "num_layers", 1)}],
        config_dir=config_dir or "configs", model_name=model_type, logger=logger,
    )
    profiles = None
    if config_dir:
        profiles = _load_profiled_tables(model_cfg, model_type, config_dir, live_world)
    if profiles is None:
        synth = analytic_model_profiles(model_cfg, max_tp=live_world)
        if synth is None:
            return None
        time_cfg, mem_cfg = synth
        allreduce, p2p, overlap = analytic_hardware_profiles(live_world)
    else:
        time_cfg, mem_cfg, allreduce, p2p, overlap = profiles
    if time_config is not None and memory_config is not None:
        time_cfg, mem_cfg = time_config, memory_config  # measured tables win
    engine.set_model_profiles(time_cfg, mem_cfg)
    engine.set_hardware_profiles(allreduce, p2p, overlap)
    engine.initialize_search_engine()
    return engine


def _load_profiled_tables(model_cfg, model_type, config_dir, world):
    """The files ``cli search`` reads for this model and world; None when
    any required table is missing or unreadable (the analytic fallback
    takes over)."""
    try:
        from galvatron_tpu_torch.profiler.model import ModelProfileArgs, ModelProfiler
        from galvatron_tpu_torch.utils.jsonio import read_json_config

        prof = ModelProfiler(model_cfg, model_name=model_type,
                             args=ModelProfileArgs(config_dir=config_dir))
        mp = prof.config_paths()
        time_cfg = read_json_config(mp["computation"])
        mem_cfg = read_json_config(mp["memory"])
        tag = "%dchips" % world
        allreduce = read_json_config(
            os.path.join(config_dir, "allreduce_bandwidth_%s.json" % tag))
        p2p_path = os.path.join(config_dir, "p2p_bandwidth_%s.json" % tag)
        p2p = read_json_config(p2p_path) if os.path.exists(p2p_path) else None
        ov_path = os.path.join(config_dir, "overlap_coefficient.json")
        overlap = read_json_config(ov_path) if os.path.exists(ov_path) else None
        return time_cfg, mem_cfg, allreduce, p2p, overlap
    except (OSError, ValueError, KeyError, TypeError):
        return None


# ------------------------------------------------------------- resume planning
@dataclass
class ElasticPlan:
    """What `resolve_resume_strategy` decided: run `hp` now; the checkpoint
    was written under `saved_hp` (the cross-strategy restore reads its
    ranks' files by it)."""

    action: str  # "match" | "strategy_file" | "search"
    hp: HybridParallelConfig
    saved_hp: HybridParallelConfig
    provenance: Dict[str, Any]
    ckpt_iteration: Optional[int] = None

    @property
    def cross_strategy(self) -> bool:
        return self.action != "match"


def _budget_refusal(hp, model_cfg, budget_gb) -> Optional[D.Diagnostic]:
    """GLS203 when the strategy's estimated stage memory exceeds the budget
    (a refusal, not the lint's warning: the resumed run would run out of
    memory minutes in)."""
    from galvatron_tpu_torch.analysis.strategy_lint import estimate_stage_memory_mb

    stage_mb = estimate_stage_memory_mb(hp, model_cfg)
    if stage_mb is None or not budget_gb:
        return None
    worst = max(stage_mb)
    if worst > budget_gb * 1024.0:
        return D.make(
            "GLS203", "stage memory estimated at %.2f GB exceeds the %.1f GB "
            "budget on the surviving %d-device mesh; lower the batch/enable "
            "checkpointing via --elastic_strategy, or raise "
            "--elastic_memory_gb" % (worst / 1024.0, budget_gb, hp.world_size),
        )
    return None


def resolve_resume_strategy(
    args: Any,
    model_cfg: Any,
    live_world: int,
    opt_args: Any = None,
) -> ElasticPlan:
    """The strategy of an elastic resume (``--elastic resume|search``).
    Raises DiagnosticError (GLS2xx) wherever resuming would corrupt or
    silently degrade training; the train CLI exits 2 on it."""
    from galvatron_tpu_torch.runtime import checkpoint as ckpt

    mode = getattr(args, "elastic", "off")
    it, prov = ckpt.read_provenance(args.load, getattr(args, "load_iteration", None))
    if prov is None:
        raise D.DiagnosticError([D.make(
            "GLS204", "checkpoint %s has no provenance manifest — it predates "
            "elastic resume; resume it on the original mesh with --elastic "
            "off (one save there upgrades it)" % args.load,
        )])
    live_digest = model_config_digest(model_cfg)
    if prov.get("model_digest") and prov["model_digest"] != live_digest:
        raise D.DiagnosticError([D.make(
            "GLS201", "checkpoint %s was written for a different model "
            "config (digest %s.. != %s..): elastic resume re-plans the "
            "PARALLELISM, never the model" % (
                args.load, prov["model_digest"][:12], live_digest[:12]),
        )])
    if opt_args is not None and prov.get("optimizer", {}).get("digest"):
        if prov["optimizer"]["digest"] != optimizer_digest(opt_args):
            telemetry.runtime_log(
                "elastic: optimizer hyperparams differ from the checkpoint's "
                "(%s); continuing — the structural guard still applies"
                % prov["optimizer"].get("kind", "?"))
    saved_world = int(prov.get("world_size", live_world))
    exec_kw = dict(
        scan_layers=getattr(args, "scan_layers", True),
        remat_policy=getattr(args, "remat_policy", "full"),
        tp_comm_mode=getattr(args, "tp_comm_mode", "gspmd"),
        tp_comm_quant=getattr(args, "tp_comm_quant", "none"),
        mixed_precision=getattr(args, "mixed_precision", "bf16"),
    )
    saved_hp = HybridParallelConfig.from_json(
        dict(prov["strategy"]), world_size=saved_world, **exec_kw)
    budget = getattr(args, "elastic_memory_gb", None) or prov.get(
        "memory_budget_gb") or DEFAULT_MEMORY_GB

    strategy_file = getattr(args, "elastic_strategy", None)
    if saved_world == live_world and not strategy_file:
        # nothing changed: the saved strategy, bitwise as a plain --load
        # (it wins over the global flags, so a stale launch script cannot
        # fork the trajectory)
        telemetry.emit("elastic", action="match", saved_world=saved_world,
                       live_world=live_world)
        return ElasticPlan("match", saved_hp, saved_hp, prov, it)

    if strategy_file:
        hp = HybridParallelConfig.from_json(strategy_file, world_size=live_world, **exec_kw)
        if saved_world == live_world and hp.to_json_dict() == saved_hp.to_json_dict():
            # the file IS the saved strategy: the plain restore applies
            telemetry.emit("elastic", action="match", saved_world=saved_world,
                           live_world=live_world)
            return ElasticPlan("match", saved_hp, saved_hp, prov, it)
        if hp.global_bsz != saved_hp.global_bsz:
            telemetry.runtime_log(
                "elastic: --elastic_strategy changes global_bsz %d -> %d; the loss "
                "trajectory will not be comparable to the original run"
                % (saved_hp.global_bsz, hp.global_bsz))
        action = "strategy_file"
    elif mode == "search":
        hp = search_surviving_strategy(
            model_cfg, live_world, saved_hp.global_bsz, budget,
            model_type=getattr(args, "model_type", "model"),
            config_dir=getattr(args, "config_dir", None),
            default_dp_type=saved_hp.default_dp_type,
        )
        if hp is None:
            raise D.DiagnosticError([D.make(
                "GLS203", "no strategy for %d surviving devices fits "
                "global_bsz=%d under the %.1f GB budget; shrink the batch "
                "with --elastic_strategy or raise --elastic_memory_gb"
                % (live_world, saved_hp.global_bsz, budget),
            )])
        for k, v in exec_kw.items():
            setattr(hp, k, v)
        action = "search"
    else:
        raise D.DiagnosticError([D.make(
            "GLS205", "world size changed %d -> %d: pass a replacement "
            "strategy via --elastic_strategy, or let the search engine "
            "re-plan with --elastic search" % (saved_world, live_world),
        )])

    from galvatron_tpu_torch.analysis import strategy_lint as _slint

    report = _slint.lint_hp(hp, model_cfg=model_cfg)
    if not report.ok:
        raise D.DiagnosticError(report.errors)
    ckpt.check_family_layout(model_cfg, saved_hp, hp)
    if action == "strategy_file":
        # the search held the budget itself; a hand-supplied strategy gets
        # the analytic check
        refusal = _budget_refusal(hp, model_cfg, budget)
        if refusal is not None:
            raise D.DiagnosticError([refusal])
    telemetry.emit("elastic", action=action, saved_world=saved_world, live_world=live_world)
    return ElasticPlan(action, hp, saved_hp, prov, it)


# ------------------------------------------------------- in-memory migration
@dataclass
class MigrationResult:
    """What `migrate` produced: run `model` with `params` / `opt_state` from
    here on (None on a rank that left the world: `departed`).
    `same_layout` records whether the pipeline layout stayed."""

    model: Any
    params: Any
    opt_state: Any
    same_layout: bool
    from_hp: HybridParallelConfig
    to_hp: HybridParallelConfig
    departed: bool = False
    seconds: float = 0.0
    device_extra_gb: Optional[float] = None


def resolve_migration_strategy(
    args: Any,
    model_cfg: Any,
    live_world: int,
    current_hp: HybridParallelConfig,
) -> Tuple[HybridParallelConfig, str]:
    """The target strategy of a LIVE migration: ``--elastic_strategy`` when
    given, else a fresh search for `live_world` under the memory budget.
    Returns (hp, action).

    Raises DiagnosticError: GLS203 when nothing fits the budget, GLS207 when
    the candidate would fork the training trajectory (another global batch
    makes "continue from the same step" meaningless: unlike a resume from
    disk, a live migration exists only to preserve the run)."""
    exec_kw = dict(
        scan_layers=current_hp.scan_layers,
        remat_policy=current_hp.remat_policy,
        tp_comm_mode=current_hp.tp_comm_mode,
        tp_comm_quant=current_hp.tp_comm_quant,
        mixed_precision=current_hp.mixed_precision,
    )
    budget = getattr(args, "elastic_memory_gb", None) or DEFAULT_MEMORY_GB
    strategy_file = getattr(args, "elastic_strategy", None)
    if strategy_file:
        hp = HybridParallelConfig.from_json(strategy_file, world_size=live_world, **exec_kw)
        action = "strategy_file"
    else:
        hp = search_surviving_strategy(
            model_cfg, live_world, current_hp.global_bsz, budget,
            model_type=getattr(args, "model_type", "model"),
            config_dir=getattr(args, "config_dir", None),
            default_dp_type=current_hp.default_dp_type,
        )
        if hp is None:
            raise D.DiagnosticError([D.make(
                "GLS203", "no strategy for %d surviving devices fits "
                "global_bsz=%d under the %.1f GB budget; supply one with "
                "--elastic_strategy or raise --elastic_memory_gb"
                % (live_world, current_hp.global_bsz, budget),
            )])
        for k, v in exec_kw.items():
            setattr(hp, k, v)
        action = "search"
    if hp.global_bsz != current_hp.global_bsz:
        raise D.DiagnosticError([D.make(
            "GLS207", "live migration cannot change global_bsz (%d -> %d): "
            "the run would fork its own trajectory; stop and resume from a "
            "checkpoint instead" % (current_hp.global_bsz, hp.global_bsz),
        )])
    from galvatron_tpu_torch.analysis import strategy_lint as _slint

    report = _slint.lint_hp(hp, model_cfg=model_cfg)
    if not report.ok:
        raise D.DiagnosticError(report.errors)
    if action == "strategy_file":
        refusal = _budget_refusal(hp, model_cfg, budget)
        if refusal is not None:
            raise D.DiagnosticError([refusal])
    return hp, action


def migrate(
    model: Any,
    params: Any,
    opt_state: Any,
    target_hp: HybridParallelConfig,
    survivors: Optional[list] = None,
    build_model: Any = None,
    reason: str = "manual",
    iteration: Optional[int] = None,
    sdc_check: bool = False,
) -> MigrationResult:
    """Move the LIVE training state onto `target_hp` without a checkpoint.

    Collective over the current world. One leaf at a time, every rank
    gathers the full parameter and both Adam moments from the old layout
    (``HybridParallelModel.gather_leaf``, on the device), frees its old
    shard and cuts its shard of the new layout (the cut of the
    cross-strategy restore: ``parallel.spec.shard_tensor`` under the target
    placements), so the device holds the live state plus one full leaf.
    Pipeline divisions change by renaming (stage trees key layers by their
    global index); a tied table's copies are cut from one gather.

    `survivors` (default: every rank) are the ranks of the current world
    that go on, in the new world's order; the others hand their shards over
    and then leave (``runtime.distributed.regroup``: a fresh rendezvous of
    the survivors on the run's store), getting a result with `departed`
    set. Then the target model is built (`build_model(cfg, hp, device)` for
    a family with its own tree) and the kept shards become its params and
    Adam state, the Adam count carried over.

    Refusals (GLS207): another global batch; a family with its own tree
    across pipeline layouts (``checkpoint.check_family_layout``). With
    `sdc_check` the layout-invariant fold (``runtime/sdc.py``) of the params
    and of the Adam state is taken before the move and asserted after it
    (GLS016). The swap is an ``elastic`` telemetry event with both
    strategies. Without an `opt_state` (a server's params,
    `migrate_serve_params`) only the params move and the global batch is
    inert."""
    import torch

    from galvatron_tpu_torch.parallel import spec as S
    from galvatron_tpu_torch.parallel.mesh import RankMesh
    from galvatron_tpu_torch.runtime import checkpoint as ckpt
    from galvatron_tpu_torch.runtime import distributed
    from galvatron_tpu_torch.runtime.model_api import (
        _set_param,
        construct_hybrid_parallel_model,
        model_def,
    )
    from galvatron_tpu_torch.runtime.optimizer import AdamState

    old_hp: HybridParallelConfig = model.hp
    if opt_state is not None and target_hp.global_bsz != old_hp.global_bsz:
        raise D.DiagnosticError([D.make(
            "GLS207", "live migration cannot change global_bsz (%d -> %d)"
            % (old_hp.global_bsz, target_hp.global_bsz))])
    ckpt.check_family_layout(model.cfg, old_hp, target_hp)
    if len(model.stages) > 1:
        raise ValueError("live migration moves the state of one stage per process; this "
                         "process hosts stages %s" % list(model.stages))
    world, rank = distributed.world_size(), distributed.rank()
    survivors = sorted(int(r) for r in (range(world) if survivors is None else survivors))
    if len(survivors) != target_hp.world_size:
        raise ValueError("migration to a world of %d with %d surviving rank(s) %s"
                         % (target_hp.world_size, len(survivors), survivors))
    device = model.device
    t0 = time.perf_counter()
    before = None
    if sdc_check:
        from galvatron_tpu_torch.runtime import sdc

        before = (sdc.state_fold(model, params),
                  sdc.state_fold(model, params, opt_state) if opt_state is not None else None)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        live_bytes = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    new_rank = survivors.index(rank) if rank in survivors else None
    arch = model_def(model.cfg, target_hp)
    specs = ckpt._saved_specs(model.cfg, target_hp)
    mesh = stage = None
    names = set()
    if new_rank is not None:
        mesh = RankMesh(target_hp, new_rank, device)
        stage = mesh.stage
        names = {n for n, _ in arch.tree("meta", stage if target_hp.pp > 1 else None)
                 .named_parameters()}
    old_specs = {"params": {n: pl.spec for n, pl in model.param_layouts.items()}}
    # the old state's leaves are emptied as they are moved: the old params
    # and Adam state are spent afterwards
    live = {"params": {s: dict(m.named_parameters()) for s, m in params.items()}}
    items = ("params",)
    count = None
    if opt_state is not None:
        old_specs["mu"] = old_specs["nu"] = model.grad_accum_specs()
        live.update(mu={s: st.mu for s, st in opt_state.items()},
                    nu={s: st.nu for s, st in opt_state.items()})
        items = ("params", "mu", "nu")
        count = int(next(iter(opt_state.values())).count)
    kept = {item: {} for item in items}
    with torch.no_grad():
        for n, _ in model.arch.tree("meta").named_parameters():
            for item in items:
                full = model.gather_leaf(live[item], n, old_specs[item][n], host=False)
                for d in live[item].values():  # the old shard is no longer needed
                    if n in d:
                        if item == "params":
                            d[n].data = d[n].data.new_empty(0)
                        else:
                            d[n] = d[n].new_empty(0)
                if n in names:
                    kept[item][n] = S.shard_tensor(full, specs[item][n], mesh).clone()
                del full
    new_rank = distributed.regroup(survivors)
    if new_rank is None:
        telemetry.emit("elastic", action="migrate", reason=reason, iter=iteration,
                       saved_world=old_hp.world_size, live_world=target_hp.world_size,
                       from_strategy=old_hp.to_json_dict(), to_strategy=target_hp.to_json_dict(),
                       duration_ms=(time.perf_counter() - t0) * 1e3,
                       same_layout=ckpt.same_pipeline_layout(old_hp, target_hp))
        return MigrationResult(None, None, None, ckpt.same_pipeline_layout(old_hp, target_hp),
                               old_hp, target_hp, departed=True,
                               seconds=time.perf_counter() - t0)
    if build_model is not None:
        new_model = build_model(model.cfg, target_hp, device)
    else:
        new_model = construct_hybrid_parallel_model(model.cfg, target_hp, device)
    new_params, new_opt = {}, ({} if opt_state is not None else None)
    for s in new_model.stages:
        module = new_model._meta_model(s)
        order = [n for n, _ in module.named_parameters()]
        for n in order:
            _set_param(module, n, kept["params"].pop(n))
        new_params[s] = module
        if new_opt is not None:
            new_opt[s] = AdamState(count=count, mu={n: kept["mu"].pop(n) for n in order},
                                   nu={n: kept["nu"].pop(n) for n in order})
    extra_gb = None
    if device.type == "cuda":  # the copies are asynchronous: time them done
        torch.cuda.synchronize(device)
        extra_gb = (torch.cuda.max_memory_allocated(device) - live_bytes) / 1e9
    if sdc_check:
        sdc.assert_digest_continuity(before[0], sdc.state_fold(new_model, new_params),
                                     "migrate(params)", iteration)
        if new_opt is not None:
            sdc.assert_digest_continuity(before[1],
                                         sdc.state_fold(new_model, new_params, new_opt),
                                         "migrate(opt_state)", iteration)
    same = ckpt.same_pipeline_layout(old_hp, target_hp)
    seconds = time.perf_counter() - t0
    telemetry.emit(
        "elastic", action="migrate", reason=reason, iter=iteration,
        saved_world=old_hp.world_size, live_world=target_hp.world_size,
        from_strategy=old_hp.to_json_dict(), to_strategy=target_hp.to_json_dict(),
        duration_ms=seconds * 1e3, same_layout=same)
    return MigrationResult(new_model, new_params, new_opt, same, old_hp, target_hp,
                           seconds=seconds, device_extra_gb=extra_gb)


# ------------------------------------------------- degraded-mesh serve path
def search_surviving_serve_strategy(
    model_cfg: Any,
    live_world: int,
    memory_budget_gb: float,
    serve_max_concurrency: int,
    serve_page_size: int,
    p99_ttft_ms: float = 0.0,
    p99_tpot_ms: float = 0.0,
    model_type: str = "model",
    config_dir: Optional[str] = None,
    default_dp_type: str = "ddp",
    logger=None,
) -> HybridParallelConfig:
    """Re-run ``search --objective serve`` for the surviving world: the same
    decode-compatible enumeration and serve cost model the offline serve
    search uses, on `config_dir`'s profiled tables for this model when it
    has them and on the analytic tables otherwise. Concurrency and page
    size are pinned to the RUNNING engine's, so in-flight journals stay
    replayable into the new cache. Raises GLS015 when no strategy is
    feasible on what survived."""
    from galvatron_tpu_torch.search.engine import SearchArgs

    heads = getattr(model_cfg, "num_heads", None) or 1
    nkv = getattr(model_cfg, "num_kv_heads", None) or heads
    args = SearchArgs(
        memory_constraint=memory_budget_gb,
        max_tp_deg=_max_tp(model_cfg, live_world),
        max_pp_deg=1,  # serve layouts are pp=1 by contract (GLS014)
        default_dp_type=default_dp_type,
        sp_space="tp",
        objective="serve",
        p99_ttft_ms=p99_ttft_ms,
        p99_tpot_ms=p99_tpot_ms,
        serve_max_concurrency=serve_max_concurrency,
        serve_page_size=serve_page_size,
        serve_kv_frac=nkv / heads,
    )
    engine = _search_engine(args, model_cfg, live_world, model_type, config_dir, logger)
    if engine is None:
        raise D.DiagnosticError([D.make(
            "GLS015", "cannot synthesize analytic cost tables for this "
            "model config — no way to re-plan serving for the %d "
            "surviving devices" % live_world,
        )])
    try:
        result = engine.serve_optimization()
    except D.DiagnosticError as e:
        # the offline objective refuses with GLS014 ("this config cannot
        # serve"); mid-flight the refusal is about the DEGRADED WORLD
        raise D.DiagnosticError([D.make(
            "GLS015", "serve world infeasible after degradation: no serving "
            "strategy for the %d surviving devices (%s); drain and redeploy "
            "on a healthy slice" % (
                live_world, "; ".join(d.message for d in e.diagnostics)[:400]),
        )]) from e
    return engine.result_to_config(result)


def resolve_serve_migration_strategy(
    args: Any,
    model_cfg: Any,
    live_world: int,
    current_hp: HybridParallelConfig,
    kv_cfg: Any = None,
) -> Tuple[HybridParallelConfig, str]:
    """The target strategy of a LIVE degraded-mesh serve migration: the
    ``--elastic_strategy`` JSON when given, otherwise a fresh ``--objective
    serve`` search for `live_world`. Returns (hp, action). Raises
    DiagnosticError (GLS015) when the surviving world cannot serve; the
    serve CLI drains and exits 2."""
    exec_kw = dict(
        scan_layers=current_hp.scan_layers,
        remat_policy=current_hp.remat_policy,
        tp_comm_mode=current_hp.tp_comm_mode,
        tp_comm_quant=current_hp.tp_comm_quant,
        mixed_precision=current_hp.mixed_precision,
    )
    budget = getattr(args, "elastic_memory_gb", None) or DEFAULT_MEMORY_GB
    concurrency = (getattr(kv_cfg, "max_slots", 0)
                   or current_hp.serve_max_concurrency or 8)
    page = (getattr(kv_cfg, "page_size", 0)
            or current_hp.serve_page_size or 16)
    strategy_file = getattr(args, "elastic_strategy", None)
    if strategy_file:
        hp = HybridParallelConfig.from_json(strategy_file, world_size=live_world, **exec_kw)
        action = "strategy_file"
    else:
        hp = search_surviving_serve_strategy(
            model_cfg, live_world, budget,
            serve_max_concurrency=concurrency, serve_page_size=page,
            p99_ttft_ms=getattr(args, "p99_ttft_ms", 0.0) or 0.0,
            p99_tpot_ms=getattr(args, "p99_tpot_ms", 0.0) or 0.0,
            model_type=getattr(args, "model_type", "model"),
            config_dir=getattr(args, "config_dir", None),
            default_dp_type=current_hp.default_dp_type,
        )
        for k, v in exec_kw.items():
            setattr(hp, k, v)
        action = "search"
    from galvatron_tpu_torch.analysis import strategy_lint as _slint
    from galvatron_tpu_torch.runtime.model_api import check_layout

    report = _slint.lint_hp(hp, model_cfg=model_cfg, mode="serve")
    problems = ["%s: %s" % (d.code, d.message) for d in report.errors]
    if not problems:
        try:
            check_layout(hp, "serve")
        except ValueError as e:
            problems.append(str(e))
    if problems:
        raise D.DiagnosticError([D.make(
            "GLS015", "serve world infeasible after degradation: the %s "
            "strategy for %d devices fails the serve lint (%s)" % (
                action, live_world, "; ".join(problems)[:400]),
        )])
    return hp, action


def migrate_serve_params(
    model: Any,
    params: Any,
    target_hp: HybridParallelConfig,
    survivors: Optional[list] = None,
    sdc_check: bool = False,
    reason: str = "degraded_mesh",
) -> MigrationResult:
    """Params-only live relayout for a serve migration: `migrate` with no
    optimizer state (serving has no training trajectory to fork; the global
    batch is inert), the target built in serve mode. Collective over the
    current world; the ranks outside `survivors` hand their shards over and
    leave (the result's `departed`). With `sdc_check` the params' layout-
    invariant fold (the fold kernel on the card) is asserted unchanged
    across the move (GLS016). The caller rebuilds the ServeEngine (a fresh
    KV cache in the new layout) and journal-replays the in-flight requests
    (``serve/engine.ContinuousBatcher.migrate_to``)."""
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    return migrate(model, params, None, target_hp, survivors=survivors,
                   build_model=lambda cfg, hp, device: construct_hybrid_parallel_model(
                       cfg, hp, device, mode="serve"),
                   reason=reason, sdc_check=sdc_check)
