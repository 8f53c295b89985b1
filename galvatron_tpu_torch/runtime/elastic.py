"""Elastic resume: re-plan the strategy for the world a run resumes on.

Port of the resume half of ``galvatron_tpu/runtime/elastic.py``. Every
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
ranks' files. Live in-memory migration (the reference's ``migrate``, the
watchdog and the mesh-health probe that trigger it) comes with
``runtime/health.py`` (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import os
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
) -> Optional[HybridParallelConfig]:
    """The strategy search for `live_world` devices under the same global
    batch and memory budget: on `config_dir`'s profiled tables for this
    model when it has them, else on the analytic tables. None when nothing
    fits (the caller's GLS203)."""
    from galvatron_tpu_torch.search.engine import GalvatronSearchEngine, SearchArgs

    heads = getattr(model_cfg, "num_heads", None) or 1
    num_layers = getattr(model_cfg, "num_layers", 1)
    seq_len = getattr(model_cfg, "max_seq_len", 2048)
    hidden = getattr(model_cfg, "hidden_size", 1024)
    # tp at most the largest power of two dividing the head count, so every
    # plan passes the model-aware GLS007 check
    max_tp = 1
    while max_tp * 2 <= min(heads, live_world) and heads % (max_tp * 2) == 0:
        max_tp *= 2
    args = SearchArgs(
        memory_constraint=memory_budget_gb,
        settle_bsz=global_bsz,  # the batch is part of the training trajectory
        settle_chunk=None,
        max_tp_deg=max_tp,
        max_pp_deg=min(_pow2_floor(num_layers), live_world),
        default_dp_type=default_dp_type,
        sp_space="tp",
    )
    engine = GalvatronSearchEngine(
        args, live_world,
        [{"hidden_size": hidden, "seq_len": seq_len, "layer_num": num_layers}],
        config_dir=config_dir or "configs", model_name=model_type,
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
    engine.set_model_profiles(time_cfg, mem_cfg)
    engine.set_hardware_profiles(allreduce, p2p, overlap)
    engine.initialize_search_engine()
    result = engine.parallelism_optimization()
    if result is None:
        return None
    return engine.result_to_config(result)


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
