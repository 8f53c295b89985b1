"""Strategy lint (``GLS***`` diagnostics): ``cli lint``, and the serve and
train entry points before they build anything.

Port of ``galvatron_tpu/analysis/strategy_lint.py``. Check layers, each
gated on the previous one constructing:

1. the raw-dict schema (``config.strategy.schema_diagnostics``): unknown
   keys with did-you-mean hints, length mismatches, bad values
   (GLS001 / GLS005 / GLS006), and GLS005 for a dict that fails to
   construct (`lint_strategy_dict`);
2. the structural checks shared with ``HybridParallelConfig.validate``
   (GLS002-GLS005);
3. the pipeline engines' contract
   (``HybridParallelConfig.pipeline_engine_diagnostics``: GPipe and ring-cp
   stage uniformity GLS010, checkpoint placement GLS011), the one rule the
   port's engines refuse by (`train_refusals`);
4. with a model config, the model-aware divisibility errors (GLS007 heads
   vs tp, GLS008 sequence vs its shard degree, GLS009 vocab vs vocab tp);
5. the warnings: the estimated per-stage memory against
   ``memory_budget_gb`` (GLS101, through the search's ``MemoryCostModel``
   on a profiled memory JSON or the analytic tables), adjacent-layer
   re-layouts (GLS102) and runnable-but-odd configs (GLS103: inert
   pipeline type, Ulysses sp at tp=1, tp_comm_mode, shadowed remat policy);
6. in serve mode the GLS014 refusals of layouts a decode engine cannot
   realise (pp>1, ring cp, Ulysses sp) and the KV budget; in train mode
   the GLS103 warnings on serve knobs and comm dtypes that cannot act, and
   the driver-state checks of the sentinel and the autotuner.

A strategy the reference refuses is refused here with the same codes, in
the same order, before any model is built. The manual-TP refusals (GLS012)
and the quantized-collective reasons of GLS013 belong to the paths of
ROADMAP queue 1 item 10; until they are ported, `lint_strategy_dict` gives
GLS013 for any quantized gradient or parameter sync, which the trainer
refuses.

`train_refusals` lists what the port's trainer does not execute: a
pipeline outside the reference engine's contract (GPipe:
``validate_pipeline_config``; 1F1B: ``validate_1f1b_config``; both raise
the refusals of layer 3), the family's refusals, and what is not ported
yet (the manual TP modes), with the ROADMAP item that brings it; the train
path raises ValueError on them (``runtime.model_api.check_layout``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from galvatron_tpu_torch.analysis import diagnostics as D
from galvatron_tpu_torch.config.strategy import HybridParallelConfig, schema_diagnostics
from galvatron_tpu_torch.utils.jsonio import read_json_config


def _model_aware_diagnostics(hp: HybridParallelConfig, model_cfg: Any) -> List[D.Diagnostic]:
    """GLS007/GLS008/GLS009: divisibility of the model's head, sequence and
    vocab dimensions by the per-layer shard degrees (fields absent from
    `model_cfg` skip their check)."""
    out: List[D.Diagnostic] = []
    num_heads = getattr(model_cfg, "num_heads", None)
    if not isinstance(num_heads, int):
        num_heads = None  # per-stage heads (Swin): its constructor checks each block's
    num_kv = getattr(model_cfg, "num_kv_heads", None) or num_heads
    seq_len = getattr(model_cfg, "max_seq_len", None)
    vocab = getattr(model_cfg, "vocab_size", None)
    for i, s in enumerate(hp.layers):
        if num_heads is not None and s.tp > 1:
            if num_heads % s.tp != 0:
                out.append(D.make("GLS007", "layer %d: num_heads=%d not divisible by tp=%d"
                                  % (i, num_heads, s.tp), layer=i))
            elif num_kv is not None and num_kv % s.tp != 0 and s.tp % num_kv != 0:
                out.append(D.make(
                    "GLS007", "layer %d: num_kv_heads=%d neither divides nor is divided by "
                    "tp=%d; GQA heads will pad/replicate unevenly" % (i, num_kv, s.tp),
                    layer=i, severity=D.WARNING))
        if seq_len is not None:
            if s.cp > 1 and seq_len % (2 * s.cp) != 0:
                out.append(D.make(
                    "GLS008", "layer %d: seq_len=%d not divisible by 2*cp=%d (ring "
                    "attention's zigzag layout needs two blocks per rank)"
                    % (i, seq_len, 2 * s.cp), layer=i))
            shard = s.seq_shard_degree * (s.tp if (not s.sp and hp.sequence_parallel) else 1)
            if shard > 1 and seq_len % shard != 0:
                out.append(D.make(
                    "GLS008", "layer %d: seq_len=%d not divisible by its sequence shard "
                    "degree %d (cp=%d, %s)" % (
                        i, seq_len, shard, s.cp,
                        "ulysses tp=%d" % s.tp if s.sp else "megatron-sp tp=%d" % s.tp),
                    layer=i))
    if vocab is not None and hp.vocab_tp > 1 and vocab % hp.vocab_tp != 0:
        out.append(D.make(
            "GLS009", "vocab_size=%d not divisible by vocab_tp=%d; pad the vocab (e.g. to "
            "%d) or lower vtp" % (vocab, hp.vocab_tp,
                                  (vocab + hp.vocab_tp - 1) // hp.vocab_tp * hp.vocab_tp),
            key="vtp"))
    if seq_len is not None and hp.vocab_cp > 1 and seq_len % hp.vocab_cp != 0:
        out.append(D.make("GLS008", "seq_len=%d not divisible by vocab_cp=%d (embed/head "
                          "sequence sharding)" % (seq_len, hp.vocab_cp), key="vcp"))
    return out


def _relayout_diagnostics(hp: HybridParallelConfig) -> List[D.Diagnostic]:
    """GLS102: adjacent layers whose activations live on different axes
    re-lay them (an all-gather or all-to-all) on every micro-batch."""
    out: List[D.Diagnostic] = []
    for i in range(1, hp.num_layers):
        a, b = hp.layers[i - 1], hp.layers[i]
        if hp.stage_of_layer[i - 1] != hp.stage_of_layer[i]:
            continue  # stage boundary: the p2p transfer reshards anyway
        moves = []
        if a.tp != b.tp or a.sp != b.sp:
            moves.append("tp%s%d->tp%s%d" % ("/sp" if a.sp else "", a.tp,
                                             "/sp" if b.sp else "", b.tp))
        if a.cp != b.cp:
            moves.append("cp%d->cp%d" % (a.cp, b.cp))
        if a.tp == b.tp and a.tp > 1 and a.tp_consec != b.tp_consec:
            moves.append("tp placement consec%d->consec%d" % (a.tp_consec, b.tp_consec))
        if moves:
            out.append(D.make(
                "GLS102", "layers %d->%d reshard activations within a stage (%s): an "
                "allgather/all-to-all per microbatch; consider aligning the run of layers"
                % (i - 1, i, ", ".join(moves)), layer=i))
    return out


def family_refusals(hp: HybridParallelConfig, model_cfg: Any) -> List[str]:
    """What a family with its own tree refuses in `hp`, as its reference
    constructor does (T5: GPipe and the enc-dec pipeline contract; Swin:
    cp and Ulysses at any pp, GPipe, heads that tp does not divide), plus
    what the port's T5 does not execute yet."""
    from galvatron_tpu_torch.models import swin, t5

    if isinstance(model_cfg, t5.T5Config):
        return t5.t5_refusals(model_cfg, hp)
    if isinstance(model_cfg, swin.SwinConfig):
        return swin.swin_refusals(model_cfg, hp)
    return []


def train_refusals(hp: HybridParallelConfig, model_cfg: Any = None) -> List[str]:
    """What the port's trainer does not execute in `hp`: the pipeline
    engine's refusal, the family's (`family_refusals`, with `model_cfg`),
    then each unported feature with the ROADMAP item (queue 1) that brings
    it; empty when it runs (context parallelism, Ulysses and vocab sp/cp
    run)."""
    out = family_refusals(hp, model_cfg) if model_cfg is not None else []
    if hp.pp > 1:
        # the pipeline's own contract, as the reference's engines refuse it
        from galvatron_tpu_torch.parallel.pipeline import validate_pipeline_config
        from galvatron_tpu_torch.parallel.pipeline_1f1b import validate_1f1b_config

        try:
            if hp.pipeline_type == "pipedream_flush":
                validate_1f1b_config(hp)
            else:
                validate_pipeline_config(hp)
        except ValueError as e:
            out.append(str(e))
    if hp.tp_comm_mode != "gspmd" and any(s.tp > 1 for s in hp.layers):
        out.append("tp_comm_mode=%r (manual TP overlap: ROADMAP queue 1 item 10)"
                   % hp.tp_comm_mode)
    return out


def serve_kv_mb_per_device(
    hp: HybridParallelConfig,
    model_cfg: Any,
    max_concurrency: int,
    page_size: int,
    dtype_bytes: int = 2,
) -> Optional[float]:
    """Per-device MB the decode KV cache pins: `max_concurrency` slots, each
    holding a full-context (k, v) pair per layer, sharded as
    ``serve/kv_cache.layer_kv_spec`` shards it (slots over dp, kv heads
    over tp when divisible). The serve search and the GLS014 budget check
    price KV through this one function, the reference's, so they agree on
    what fits (where kv is replicated, nkv < tp, the port's rank holds one
    kv head of the nkv priced here)."""
    nh = getattr(model_cfg, "num_heads", None)
    hd = getattr(model_cfg, "head_dim", None)
    seq = getattr(model_cfg, "max_seq_len", None)
    if nh is None or seq is None:
        return None
    nkv = getattr(model_cfg, "num_kv_heads", None) or nh
    hd = hd or getattr(model_cfg, "hidden_size") // nh
    page = max(int(page_size), 1)
    max_ctx = -(-seq // page) * page  # bucket-quantised full context
    total = 0.0
    for i, s in enumerate(hp.layers):
        slots_per_dev = max_concurrency / max(hp.dp(i), 1)
        heads_per_dev = nkv / s.tp if (s.tp > 1 and nkv % s.tp == 0) else nkv
        total += 2.0 * slots_per_dev * max_ctx * heads_per_dev * hd * dtype_bytes
    return total / 2**20


def _serve_diagnostics(hp: HybridParallelConfig, model_cfg: Any = None,
                       memory_budget_gb: Optional[float] = None) -> List[D.Diagnostic]:
    """GLS014: layouts a decode engine cannot realise
    (``serve/kv_cache.py`` raises the same refusals at construction), and
    with a `memory_budget_gb` the KV cache of ``serve_max_concurrency``
    slots plus the bf16 weights over the budget."""
    out: List[D.Diagnostic] = []
    if hp.pp > 1:
        out.append(D.make(
            "GLS014", "pp=%d: the decode engine drives single-token steps "
            "over one stage; pipeline parallelism is unsupported in serve "
            "mode" % hp.pp, key="pp_deg",
        ))
    for i, s in enumerate(hp.layers):
        if s.cp > 1:
            out.append(D.make(
                "GLS014", "layer %d: cp=%d — ring context parallelism never "
                "materialises the full per-layer k/v, so a decode cache "
                "cannot be filled; serve layouts require cp=1" % (i, s.cp),
                layer=i,
            ))
            break
    for i, s in enumerate(hp.layers):
        if s.sp:
            out.append(D.make(
                "GLS014", "layer %d: use_sp=1 (Ulysses) repurposes the tp "
                "axes for sequence all-to-alls a length-1 decode query "
                "cannot use; serve layouts require sp=0" % i, layer=i,
            ))
            break
    conc = hp.serve_max_concurrency
    if conc > 0 and model_cfg is not None and memory_budget_gb:
        kv_mb = serve_kv_mb_per_device(hp, model_cfg, conc, hp.serve_page_size or 16)
        layer_mb = _analytic_parameter_mb(model_cfg)
        if kv_mb is not None and layer_mb is not None:
            # bf16 inference weights, sharded over tp (and dp when fsdp)
            param_mb = sum(layer_mb / 2.0 / s.tp / (hp.dp(i) if s.fsdp else 1)
                           for i, s in enumerate(hp.layers))
            budget_mb = memory_budget_gb * 1024.0
            if kv_mb + param_mb > budget_mb:
                out.append(D.make(
                    "GLS014", "KV cache for %d concurrent slots needs %.1f MB"
                    "/device on top of %.1f MB of weights — over the %.1f GB "
                    "budget; lower concurrency, context, or raise tp/dp"
                    % (conc, kv_mb, param_mb, memory_budget_gb),
                    key="serve_max_concurrency",
                ))
    return out


# ------------------------------------------------------ analytic memory tables
def _analytic_parameter_mb(model_cfg: Any) -> Optional[float]:
    """fp32 MB of one transformer layer's parameters, from the model config
    alone (used when no profiled memory table is supplied)."""
    h = getattr(model_cfg, "hidden_size", None)
    nh = getattr(model_cfg, "num_heads", None)
    if h is None or nh is None:
        return None
    nkv = getattr(model_cfg, "num_kv_heads", None) or nh
    ffn = getattr(model_cfg, "ffn_hidden", None) or 4 * h
    attn = h * h * (2.0 + 2.0 * nkv / nh)  # q,o full; k,v scaled by GQA
    mlp_mats = 3 if getattr(model_cfg, "activation", "gelu") == "swiglu" else 2
    mlp = mlp_mats * h * ffn
    return (attn + mlp) * 4.0 / 2**20


def _analytic_activation_dict(model_cfg: Any, max_tp: int) -> Optional[Dict[Any, float]]:
    """Megatron-style per-sample live-activation MB per layer, keyed by tp
    degree (+ 'checkpoint' = the layer input only). bf16 residual stream:
    ~34*s*h bytes of intermediates + 5*a*s^2 of attention scores."""
    h = getattr(model_cfg, "hidden_size", None)
    nh = getattr(model_cfg, "num_heads", None)
    s = getattr(model_cfg, "max_seq_len", None)
    if h is None or nh is None or s is None:
        return None
    base = (34.0 * s * h + 5.0 * nh * s * s) / 2**20
    d: Dict[Any, float] = {"checkpoint": 2.0 * s * h / 2**20}
    t = 1
    while t <= max_tp:
        d[t] = base / t
        t *= 2
    return d


def estimate_stage_memory_mb(
    hp: HybridParallelConfig,
    model_cfg: Any = None,
    memory_profile: Optional[dict] = None,
) -> Optional[List[float]]:
    """Per-pipeline-stage estimated device memory (MB), priced through the
    search engine's MemoryCostModel so the budget check and the search
    agree on what fits. `memory_profile` is the profiler's memory JSON
    (``layertype_0`` schema); without it, analytic tables derived from the
    model config are used. Returns None when neither source has enough
    information."""
    from galvatron_tpu_torch.search.cost_model import MemoryCostModel
    from galvatron_tpu_torch.search.cost_model_args import (
        ModelArgs,
        ParallelArgs,
        ProfileModelArgs,
        TrainArgs,
    )

    per_stage = hp.per_stage_devices
    if memory_profile is not None and "layertype_0" in memory_profile:
        lt = memory_profile["layertype_0"]
        param_mb = float(lt["parameter_size"])
        act_dict = dict(lt["tp_activation_per_bsz_dict"])
    else:
        param_mb = _analytic_parameter_mb(model_cfg) if model_cfg is not None else None
        act_dict = (
            _analytic_activation_dict(model_cfg, per_stage)
            if model_cfg is not None else None
        )
    if param_mb is None or not act_dict:
        return None
    seq_len = getattr(model_cfg, "max_seq_len", 2048) if model_cfg is not None else 2048
    hidden = getattr(model_cfg, "hidden_size", 1024) if model_cfg is not None else 1024
    ma = ModelArgs(parameter_size=param_mb, seq_length=seq_len,
                   hidden_size=hidden, layer_num=hp.num_layers)
    ta = TrainArgs(mixed_precision=hp.mixed_precision == "bf16")
    pa = ParallelArgs(
        use_zero2_for_dp=hp.default_dp_type == "zero2",
        sequence_parallel=hp.sequence_parallel,
        chunks=hp.chunks,
        pipeline_type=hp.pipeline_type,
        disable_vtp=True,  # embed/head priced analytically below
    )
    stage_mb = [0.0] * hp.pp
    for i, s in enumerate(hp.layers):
        info: Dict[str, Any] = {}
        if s.sp:
            info["sp"] = 1
        if s.cp > 1:
            info["cp"] = s.cp
        if s.fsdp:
            info["fsdp"] = 1
        if s.checkpoint:
            info["cpt"] = 1
            if s.remat_policy != "full":
                info["rp"] = s.remat_policy
        strategy = [hp.pp, s.tp, hp.dp(i), info]
        cost = MemoryCostModel(
            strategy, global_batch_size=hp.global_bsz,
            mbsz=max(1, hp.global_bsz // max(1, hp.chunks)),
            min_tp=1, max_tp=per_stage, model_args=ma, train_args=ta,
            parallel_args=pa,
            profile_model_args=ProfileModelArgs(tp_activation_per_bsz_dict=act_dict),
        ).get_memory_cost()
        stage_mb[hp.stage_of_layer[i]] += cost["enc_total"]
    # embed/head states: vocab-parallel table(s), Adam fp32 states (~4x),
    # sharded over vocab_tp (and over pp for the 1F1B storage layout)
    vocab = getattr(model_cfg, "vocab_size", None) if model_cfg is not None else None
    if vocab is not None:
        tables = 1 if getattr(model_cfg, "tie_embeddings", True) else 2
        vmb = tables * vocab * hidden * 4.0 * 4.0 / 2**20 / hp.vocab_tp
        if hp.pp == 1:
            stage_mb[0] += vmb
        elif hp.pipeline_type == "pipedream_flush":
            for st in range(hp.pp):
                stage_mb[st] += vmb / hp.pp
        else:
            stage_mb[0] += vmb / tables
            stage_mb[-1] += vmb / tables
    return stage_mb


def _warning_diagnostics(hp: HybridParallelConfig, model_cfg: Any = None,
                         memory_budget_gb: Optional[float] = None,
                         memory_profile: Optional[dict] = None) -> List[D.Diagnostic]:
    """GLS102, then GLS103: runnable but almost certainly not what was
    meant; then GLS101: a stage whose estimated memory exceeds
    `memory_budget_gb`."""
    out: List[D.Diagnostic] = _relayout_diagnostics(hp)
    if hp.pp == 1 and hp.pipeline_type == "pipedream_flush":
        out.append(D.make("GLS103", "pipeline_type='pipedream_flush' with pp=1 runs the "
                          "plain single-stage path; the flag is inert", key="pipeline_type"))
    for i, s in enumerate(hp.layers):
        if s.sp and s.tp == 1:
            out.append(D.make("GLS103", "layer %d: use_sp=1 with tp=1 is a no-op (ulysses "
                              "repurposes the tp axis)" % i, layer=i))
            break
    if hp.tp_comm_mode != "gspmd" and all(s.tp <= 1 for s in hp.layers):
        out.append(D.make("GLS103", "tp_comm_mode=%r with tp=1 on every layer is inert: "
                          "there are no TP collectives to make visible or overlap"
                          % hp.tp_comm_mode, key="tp_comm_mode"))
    if hp.remat_policy != "full" and any(s.remat_policy != hp.remat_policy for s in hp.layers):
        out.append(D.make(
            "GLS103", "global remat_policy=%r is shadowed by serialized per-layer policies "
            "(%d of %d layers differ): the per-layer field is authoritative; drop the flag "
            "or edit the JSON" % (
                hp.remat_policy, sum(1 for s in hp.layers if s.remat_policy != hp.remat_policy),
                hp.num_layers), key="remat_policy"))
    if memory_budget_gb:
        stage_mb = estimate_stage_memory_mb(hp, model_cfg, memory_profile)
        for st, mb in enumerate(stage_mb or ()):
            if mb > memory_budget_gb * 1024.0:
                out.append(D.make(
                    "GLS101", "stage %d estimated %.2f GB exceeds the %.1f GB budget (%s "
                    "estimate via MemoryCostModel)" % (
                        st, mb / 1024.0, memory_budget_gb,
                        "profiled" if memory_profile else "analytic")))
    return out


def _train_diagnostics(hp: HybridParallelConfig) -> List[D.Diagnostic]:
    """GLS103: knobs the training loop cannot act on."""
    out: List[D.Diagnostic] = []
    if hp.serve_max_concurrency or hp.serve_page_size:
        out.append(D.make("GLS103", "serve_max_concurrency/serve_page_size are inert in "
                          "train mode: only the serve engine allocates a KV cache",
                          key="serve_max_concurrency"))
    if hp.serve_p99_ttft_ms or hp.serve_max_pending:
        out.append(D.make("GLS103", "serve_p99_ttft_ms/serve_max_pending are inert in "
                          "train mode: admission control and overload shedding live in "
                          "the serve batcher, not the training loop", key="serve_p99_ttft_ms"))
    if any(s.grad_comm_dtype != "none" or s.param_comm_dtype != "none" for s in hp.layers):
        try:
            inert = all(hp.dp(i) <= 1 for i in range(hp.num_layers))
        except Exception:
            inert = False  # broken grids already reported by GLS002
        if inert:
            out.append(D.make("GLS103", "grad/param comm dtypes are set but every layer has "
                              "dp=1: there is no gradient sync to quantize",
                              key="grad_comm_dtype"))
    return out


def _resilience_diagnostics(hp: HybridParallelConfig, sdc_check=None, sdc_interval=None,
                            autotune=None, autotune_margin=None,
                            elastic_strategy=None) -> List[D.Diagnostic]:
    """The driver-state checks of the reference's lint: a vote sentinel the
    layout downgrades to digest and an inert ``sdc_interval`` (GLS103),
    ``--autotune apply`` against a pinned ``--elastic_strategy`` (GLS017),
    autotune under a pipeline and an inert ``autotune_margin`` (GLS103)."""
    out: List[D.Diagnostic] = []
    if sdc_check == "vote":
        from galvatron_tpu_torch.runtime.sdc import vote_reason

        reason = vote_reason(hp)
        if reason is not None:
            out.append(D.make(
                "GLS103", "sdc_check=vote downgrades to digest on this layout (%s): "
                "cross-replica voting needs a full per-device parameter replica" % reason,
                key="sdc_check"))
    if sdc_interval and (sdc_check or "off") == "off":
        out.append(D.make("GLS103", "sdc_interval is inert with sdc_check off: there is no "
                          "integrity digest to emit", key="sdc_interval"))
    mode = autotune or "off"
    if mode == "apply" and elastic_strategy:
        out.append(D.make(
            "GLS017", "--autotune apply with a pinned --elastic_strategy: any strategy the "
            "autotuner swaps to would be reverted by the next migration resolving back to the "
            "pinned JSON; drop one of the two (observe mode composes fine)", key="autotune"))
    if mode != "off" and hp.pp > 1:
        out.append(D.make(
            "GLS103", "autotune with pp=%d: the calibration splits the measured step by each "
            "LayerRun's FLOPs share, which a pipeline's bubble does not follow, so the "
            "measured tables are coarser" % hp.pp, key="autotune"))
    if autotune_margin is not None and mode == "off":
        out.append(D.make("GLS103", "autotune_margin is inert with autotune off: there is no "
                          "re-search decision to apply the hysteresis to",
                          key="autotune_margin"))
    return out


def lint_hp(
    hp: HybridParallelConfig,
    model_cfg: Any = None,
    file: Optional[str] = None,
    mode: Optional[str] = None,
    memory_budget_gb: Optional[float] = None,
    memory_profile: Optional[dict] = None,
    sdc_check: Optional[str] = None,
    sdc_interval: Optional[int] = None,
    autotune: Optional[str] = None,
    autotune_margin: Optional[float] = None,
    elastic_strategy: Optional[str] = None,
) -> D.DiagnosticReport:
    """Lint an already-constructed config: structural checks, the pipeline
    engines' contract (GLS010 / GLS011), with `model_cfg` the model-aware
    GLS007-009, the GLS102/GLS103 warnings, with `memory_budget_gb` the
    GLS101 estimate (on `memory_profile`, the profiler's memory JSON, when
    given), plus the GLS014 serve-feasibility layer when ``mode="serve"``
    (with `memory_budget_gb`, the KV + weight budget check) and the
    train-mode GLS103 warnings when ``mode="train"``; the train driver's
    state (the sentinel, the autotuner, a pinned elastic strategy) adds
    the reference's GLS103 / GLS017 checks of it."""
    report = D.DiagnosticReport()
    report.extend(hp.structural_diagnostics())
    report.extend(hp.pipeline_engine_diagnostics())
    if model_cfg is not None:
        report.extend(_model_aware_diagnostics(hp, model_cfg))
    report.extend(_warning_diagnostics(hp, model_cfg, memory_budget_gb, memory_profile))
    if mode == "serve":
        report.extend(_serve_diagnostics(hp, model_cfg, memory_budget_gb))
    elif mode == "train":
        report.extend(_train_diagnostics(hp))
    report.extend(_resilience_diagnostics(hp, sdc_check, sdc_interval, autotune,
                                          autotune_margin, elastic_strategy))
    return _with_file(report, file)


def _quant_comm_refusal(hp: HybridParallelConfig) -> List[D.Diagnostic]:
    """GLS013: a quantized gradient or parameter sync on a layer with a dp
    group, which the port's trainer refuses (ROADMAP queue 1 item 10)."""
    if not any(hp.dp(i) > 1 and (s.grad_comm_dtype != "none" or s.param_comm_dtype != "none")
               for i, s in enumerate(hp.layers)):
        return []
    return [D.make("GLS013", "quantized collectives: the port syncs gradients and parameters "
                   "in full precision; quantized syncs come with ROADMAP queue 1 item 10",
                   key="grad_comm_dtype")]


def lint_strategy_dict(cfg_dict: dict, world_size: int, model_cfg: Any = None,
                       memory_budget_gb: Optional[float] = None,
                       memory_profile: Optional[dict] = None, file: Optional[str] = None,
                       mode: Optional[str] = None, **overrides) -> D.DiagnosticReport:
    """Lint a raw strategy dict (the on-disk JSON schema) bottom-up. Stops
    after the schema layer if the dict cannot construct at all (GLS005 for
    a construction failure the schema does not name). Outside serve mode
    it adds the port's GLS013 refusal of quantized syncs."""
    report = D.DiagnosticReport()
    schema = schema_diagnostics(cfg_dict)
    report.extend(schema)
    if any(d.severity == D.ERROR for d in schema):
        return _with_file(report, file)
    try:
        hp = HybridParallelConfig.from_json(cfg_dict, world_size=world_size, **overrides)
    except D.DiagnosticError as e:
        report.extend(e.diagnostics)
        return _with_file(report, file)
    except (KeyError, ValueError, TypeError) as e:
        report.add(D.make("GLS005", "config failed to construct: %s" % e))
        return _with_file(report, file)
    report.extend(lint_hp(hp, model_cfg=model_cfg, memory_budget_gb=memory_budget_gb,
                          memory_profile=memory_profile, mode=mode).diagnostics)
    if mode != "serve":
        report.extend(_quant_comm_refusal(hp))
    return _with_file(report, file)


def lint_strategy_file(path: str, world_size: int, model_cfg: Any = None,
                       memory_budget_gb: Optional[float] = None,
                       memory_profile: Optional[dict] = None, mode: Optional[str] = None,
                       **overrides) -> D.DiagnosticReport:
    return lint_strategy_dict(read_json_config(path), world_size, model_cfg=model_cfg,
                              memory_budget_gb=memory_budget_gb,
                              memory_profile=memory_profile, file=path, mode=mode,
                              **overrides)


def _with_file(report: D.DiagnosticReport, file: Optional[str]) -> D.DiagnosticReport:
    if file:
        report.diagnostics = [D.Diagnostic(**{**d.__dict__, "file": d.file or file})
                              for d in report.diagnostics]
    return report
