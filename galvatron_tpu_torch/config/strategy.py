"""Layer-wise hybrid-parallel strategy schema.

Port of ``galvatron_tpu/config/strategy.py``: the same reference-compatible
on-disk JSON (`pp_deg`, `tp_sizes_enc`, `tp_consecutive_flags`,
`dp_types_enc`, `use_sp`, `checkpoint`, `pp_division`, `vtp`/`vsp`/`vcp`,
`global_bsz`, `chunks`, `pipeline_type`, `default_dp_type`, `embed_sdp`, the
per-layer comm dtypes and remat policies, and the `serve_*` knobs), the same
structural validation with the same GLS codes, and the same `layer_runs`
grouping. A searched strategy JSON therefore loads to equal configs in both
packages.

Semantics (mirroring the reference):
- ``tp``       per-layer tensor-parallel degree (Megatron-style).
- ``sp``       per-layer flag: 1 => the tp axis carries Ulysses sequence
               parallelism for this layer.
- ``cp``       per-layer context-parallel (ring attention) degree.
- ``fsdp``     per-layer flag: 1 => ZeRO-3 for this layer; 0 =>
               ``default_dp_type`` (ddp / zero2 / zero3).
- ``checkpoint`` per-layer activation-rematerialisation flag.
- ``tp_consec``  whether tp takes the minor (consecutive) or major sub-axes.
- ``vocab_tp/vocab_sp/vocab_cp`` separate degrees for embedding/cls layers.
- ``embed_sdp``  ZeRO-3 for embedding/cls.

The per-layer data-parallel degree is derived:
``dp = world_size // pp // tp // cp`` (sp shares the tp sub-axes).

Which layouts this package can execute is decided by the runtime
(`runtime/model_api.py`), not here: the schema stays the reference's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence

from galvatron_tpu_torch.analysis import diagnostics as D
from galvatron_tpu_torch.utils.jsonio import read_json_config, write_json_config
from galvatron_tpu_torch.parallel.mesh import layer_axes
from galvatron_tpu_torch.utils.strategy_utils import array2str, str2array

DP_TYPES = ("ddp", "zero2", "zero3")
PIPELINE_TYPES = ("gpipe", "pipedream_flush")
CP_MODES = ("ring", "zigzag")
# jax.checkpoint policy applied to layers with checkpoint=1 (models/base.py
# _remat): "full" is jax.checkpoint's default (save nothing, remat
# everything — the reference's --checkpoint semantics), "none" disables the
# layer's checkpoint flag entirely, the *_saveable names select the
# matching jax.checkpoint_policies member (dots_saveable keeps matmul
# outputs resident and remats only the cheap elementwise chains).
# A SERIALIZED per-layer strategy field since the remat search dimension
# (LayerStrategy.remat_policy; on-disk key "remat_policy"): the search
# engine chooses the policy per layer under the memory budget, exactly like
# grad_comm_dtype. The global --remat_policy CLI flag survives only as a
# default-override (HybridParallelConfig.remat_policy): it fills layers
# whose JSON does not serialize the key; serialized per-layer values always
# win, and a non-default flag shadowed by them warns GLS103.
REMAT_POLICIES = ("none", "full", "dots_saveable", "nothing_saveable")
# TP-collective execution path for layer runs (models/base.run_layers —
# parallel/tp_shard_map.py): "gspmd" leaves the collectives to the
# compiler (they serialize with the matmuls), "shard_map" hand-writes them
# (visible/schedulable, undecomposed), "overlap" decomposes them into
# ppermute-pipelined chunked matmuls (ring all-gather / reduce-scatter
# overlapped with compute, the ring_attention idiom on the dense kernels).
# A runtime knob: NOT serialized into the strategy JSON.
TP_COMM_MODES = ("gspmd", "shard_map", "overlap")
# Wire precision of a collective's payload (parallel/quant_collectives.py):
# "none" keeps the exact full-precision collective, "bf16" is a passthrough
# cast, int8/fp8_e4m3 are blockwise-quantized (per-block absmax scales,
# block size = comm_quant_block). grad_comm_dtype (DP/ZeRO gradient sync)
# and param_comm_dtype (ZeRO-3 weight all-gather) are SERIALIZED per-layer
# strategy fields — the search engine chooses them per layer (ROADMAP item
# 2) — unlike tp_comm_quant, which quantizes the PR-8 TP ring payloads and
# stays a runtime knob like tp_comm_mode.
COMM_DTYPES = ("none", "bf16", "int8", "fp8_e4m3")

# The reference-compatible on-disk schema (from_json/to_json_dict). Split by
# shape so the schema linter can check lengths/types uniformly.
PER_LAYER_KEYS = (
    "tp_sizes_enc", "tp_consecutive_flags", "cp_sizes_enc", "dp_types_enc",
    "use_sp", "checkpoint",
)
# per-layer comma-separated STRING enums, not int lists; each key validates
# against its own allowed-value set (schema_diagnostics)
PER_LAYER_STR_ENUMS = {
    "grad_comm_dtype": COMM_DTYPES,
    "param_comm_dtype": COMM_DTYPES,
    "remat_policy": REMAT_POLICIES,
}
PER_LAYER_STR_KEYS = tuple(PER_LAYER_STR_ENUMS)
SCALAR_KEYS = (
    "pp_deg", "global_bsz", "chunks", "pp_division", "pipeline_type",
    "default_dp_type", "vtp", "vsp", "vcp", "embed_sdp", "cp_mode",
    "comm_quant_block", "serve_max_concurrency", "serve_page_size",
    "serve_p99_ttft_ms", "serve_max_pending",
)
KNOWN_STRATEGY_KEYS = frozenset(PER_LAYER_KEYS + PER_LAYER_STR_KEYS + SCALAR_KEYS)
REQUIRED_STRATEGY_KEYS = ("pp_deg", "tp_sizes_enc", "dp_types_enc")


def str2strlist(v) -> List[str]:
    """'none,int8,int8' -> ['none', 'int8', 'int8'] (the string-enum
    analogue of utils.strategy_utils.str2array)."""
    if isinstance(v, (list, tuple)):
        return [str(x).strip() for x in v]
    return [s.strip() for s in str(v).split(",") if s.strip()]


def strlist2str(vals: Sequence[str]) -> str:
    return ",".join(str(v) for v in vals)


def schema_diagnostics(cfg: dict) -> list:
    """Raw strategy-dict checks shared by `from_json` (which raises on any
    error) and the strategy linter (which reports them all): unknown keys
    with did-you-mean hints (GLS001), missing required keys (GLS005),
    per-layer array length disagreements (GLS006), out-of-range enum values
    and flags (GLS005). Returns a list of Diagnostics."""
    out = []
    for k in sorted(cfg):
        if k not in KNOWN_STRATEGY_KEYS:
            out.append(D.make(
                "GLS001", "unknown strategy key %r" % k, key=k,
                hint=D.did_you_mean(k, KNOWN_STRATEGY_KEYS),
            ))
    for k in REQUIRED_STRATEGY_KEYS:
        if k not in cfg:
            out.append(D.make("GLS005", "missing required key %r" % k, key=k))
    arrays = {}
    for k in PER_LAYER_KEYS:
        if k in cfg:
            try:
                arrays[k] = str2array(cfg[k])
            except ValueError:
                out.append(D.make(
                    "GLS005", "key %r is not a comma-separated int list: %r"
                    % (k, cfg[k]), key=k,
                ))
    str_arrays = {}
    for k, allowed in PER_LAYER_STR_ENUMS.items():
        if k in cfg:
            str_arrays[k] = str2strlist(cfg[k])
            for i, v in enumerate(str_arrays[k]):
                if v not in allowed:
                    out.append(D.make(
                        "GLS005", "%s[%d]=%r must be one of %s"
                        % (k, i, v, allowed), key=k, layer=i,
                        hint=D.did_you_mean(v, allowed),
                    ))
    # a serialized remat_policy of all-"full" carries no information: "full"
    # is what checkpoint=1 already means (and the from_json default), so the
    # key only earns its place when some layer deviates
    rp_vals = str_arrays.get("remat_policy")
    if rp_vals and all(v == "full" for v in rp_vals):
        out.append(D.make(
            "GLS103", "serialized remat_policy is 'full' on every layer — it "
            "duplicates the checkpoint flag (checkpoint=1 already remats "
            "fully); drop the key", key="remat_policy",
        ))
    if "tp_sizes_enc" in arrays:
        n = len(arrays["tp_sizes_enc"])
        for k, arr in list(arrays.items()) + list(str_arrays.items()):
            if len(arr) != n:
                out.append(D.make(
                    "GLS006", "%r has %d entries but 'tp_sizes_enc' has %d"
                    % (k, len(arr), n), key=k,
                ))
    cqb = cfg.get("comm_quant_block")
    if cqb is not None and (not isinstance(cqb, int) or cqb < 1):
        out.append(D.make(
            "GLS005", "comm_quant_block must be a positive int, got %r" % (cqb,),
            key="comm_quant_block",
        ))
    for k in ("serve_max_concurrency", "serve_page_size", "serve_max_pending"):
        sv = cfg.get(k)
        if sv is not None and (not isinstance(sv, int) or sv < 0):
            out.append(D.make(
                "GLS005", "%s must be a non-negative int, got %r" % (k, sv),
                key=k,
            ))
    ttft = cfg.get("serve_p99_ttft_ms")
    if ttft is not None and (not isinstance(ttft, (int, float))
                             or isinstance(ttft, bool) or ttft < 0):
        out.append(D.make(
            "GLS005", "serve_p99_ttft_ms must be a non-negative number, "
            "got %r" % (ttft,), key="serve_p99_ttft_ms",
        ))
    for k, lo in (("tp_sizes_enc", 1), ("cp_sizes_enc", 1)):
        for i, v in enumerate(arrays.get(k, [])):
            if v < lo:
                out.append(D.make(
                    "GLS005", "%s[%d]=%d must be >= %d" % (k, i, v, lo),
                    key=k, layer=i,
                ))
    for k in ("dp_types_enc", "use_sp", "checkpoint", "tp_consecutive_flags"):
        for i, v in enumerate(arrays.get(k, [])):
            if v not in (0, 1):
                out.append(D.make(
                    "GLS005", "%s[%d]=%d must be 0 or 1" % (k, i, v),
                    key=k, layer=i,
                ))
    for k, allowed in (
        ("pipeline_type", PIPELINE_TYPES),
        ("default_dp_type", DP_TYPES),
        ("cp_mode", CP_MODES),
    ):
        v = cfg.get(k)
        if v is not None and v not in allowed:
            out.append(D.make(
                "GLS005", "%s must be one of %s, got %r" % (k, allowed, v),
                key=k, hint=D.did_you_mean(str(v), allowed),
            ))
    return out


@dataclass(frozen=True)
class LayerStrategy:
    """Parallel strategy for a single transformer layer."""

    tp: int = 1
    cp: int = 1
    sp: int = 0
    fsdp: int = 0
    checkpoint: int = 0
    tp_consec: int = 1
    # wire precision of this layer's collectives (COMM_DTYPES; serialized —
    # the search engine's comm-precision axis chooses these per layer):
    grad_comm_dtype: str = "none"   # DP/ZeRO gradient sync payload
    param_comm_dtype: str = "none"  # ZeRO-3 weight all-gather payload
    # jax.checkpoint policy this layer remats under when checkpoint=1
    # (REMAT_POLICIES; serialized — the search engine's remat axis chooses
    # the recompute-vs-memory point per layer). Inert on checkpoint=0
    # layers; "none" disables remat for this layer even with checkpoint=1.
    remat_policy: str = "full"

    def __post_init__(self):
        if self.tp < 1 or self.cp < 1:
            raise ValueError("tp/cp degrees must be >= 1, got tp=%d cp=%d" % (self.tp, self.cp))
        if self.sp not in (0, 1) or self.fsdp not in (0, 1):
            raise ValueError("sp/fsdp must be 0/1")
        for k in ("grad_comm_dtype", "param_comm_dtype"):
            if getattr(self, k) not in COMM_DTYPES:
                raise ValueError("%s must be one of %s, got %r"
                                 % (k, COMM_DTYPES, getattr(self, k)))
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError("remat_policy must be one of %s, got %r"
                             % (REMAT_POLICIES, self.remat_policy))

    @property
    def effective_remat_policy(self) -> str:
        """The jax.checkpoint policy this layer actually executes under:
        checkpoint=0 layers never wrap (their serialized policy is inert),
        and checkpoint=1 with remat_policy='none' opts the layer out. The
        runtime (models/base.run_layers), the run splitter (layer_runs) and
        the cost models all key on THIS, so inert differences never split a
        scan run or fork a cost-model cache entry."""
        return self.remat_policy if self.checkpoint else "none"

    @property
    def seq_shard_degree(self) -> int:
        """How many ways the sequence dim is sharded inside this layer's
        attention: cp always shards the sequence; ulysses-sp shards it by tp."""
        return self.cp * (self.tp if self.sp else 1)


@dataclass(frozen=True)
class LayerRun:
    """A maximal run of consecutive layers that compile to ONE program: every
    layer in [start, stop) has the same mesh-axis assignment (LayerAxes),
    the same effective rematerialization policy (checkpoint flag + per-layer
    remat_policy), and lives on the same pipeline stage. The runtime
    executes a run of length >= 2 as a single `jax.lax.scan` over
    weight-stacked params (models/base.py run_layers), so trace/compile
    cost is per-RUN, not per-layer."""

    start: int
    stop: int  # exclusive
    strategy: LayerStrategy  # the run's shared strategy (first layer's)

    @property
    def length(self) -> int:
        return self.stop - self.start

    @property
    def layer_indices(self) -> range:
        return range(self.start, self.stop)


def layer_runs(config: "HybridParallelConfig") -> List[LayerRun]:
    """Partition ``config.layers`` into maximal scannable runs.

    Layers are grouped by the *realised* strategy — the LayerAxes their
    LayerStrategy maps to on this mesh — not by raw LayerStrategy equality,
    so inert flag differences (e.g. ``sp`` or ``tp_consec`` at tp=1, or a
    remat_policy on a checkpoint=0 layer) do not split a run. The effective
    remat policy partitions (checkpoint flag + remat_policy — each policy
    wraps the scanned body in a different jax.checkpoint program) and runs
    never span a pipeline-stage boundary. Searched strategies are
    piecewise-uniform in practice (PAPER.md), so this typically yields a
    handful of runs regardless of depth."""
    stage_of = config.stage_of_layer
    out: List[LayerRun] = []
    prev_key = None
    for i in range(config.num_layers):
        key = (layer_axes(config, i),
               config.layers[i].effective_remat_policy, stage_of[i])
        if out and key == prev_key:
            out[-1] = dataclasses.replace(out[-1], stop=i + 1)
        else:
            out.append(LayerRun(start=i, stop=i + 1, strategy=config.layers[i]))
        prev_key = key
    return out


def even_pp_division(total_layers: int, pp: int) -> List[int]:
    """Default layer division across pipeline stages (reference
    hybrid_parallel_config.py:86-89: equal with remainder on last stage)."""
    avg = total_layers // pp
    return [avg] * (pp - 1) + [total_layers - avg * (pp - 1)]


def pp_stage_of_layer(pp_division: Sequence[int]) -> List[int]:
    """`pp_ranks_enc` in the reference (hybrid_parallel_config.py:9-14)."""
    out: List[int] = []
    for stage, n in enumerate(pp_division):
        out += [stage] * n
    return out


@dataclass
class HybridParallelConfig:
    """Whole-model layer-wise hybrid-parallel configuration."""

    world_size: int
    pp: int
    layers: List[LayerStrategy]
    global_bsz: int = 8
    chunks: int = 1
    pp_division: Optional[List[int]] = None
    pipeline_type: str = "gpipe"
    default_dp_type: str = "ddp"
    vocab_tp: int = 1
    vocab_sp: int = 0
    vocab_cp: int = 1
    embed_sdp: int = 0
    mixed_precision: str = "bf16"
    sequence_parallel: bool = True  # Megatron-SP activation sharding when tp>1
    cp_mode: str = "zigzag"  # ring | zigzag — zigzag applies the balanced data
    # layout as a global sequence permutation in the input pipeline
    # (reference --cp_mode, runtime/arguments.py; redistribute.py:8-44)
    # Runtime execution knobs (like mixed_precision/sequence_parallel, these
    # are NOT part of the searched on-disk strategy schema):
    scan_layers: bool = True  # stack same-strategy layer runs into lax.scan
    # (depth-constant trace/compile cost); False = unroll every layer
    # Global remat default-override (REMAT_POLICIES). PRECEDENCE RULE: the
    # per-layer LayerStrategy.remat_policy is authoritative at runtime; this
    # field only FILLS layers at construction — uniform() stamps it on every
    # layer, from_json uses it for JSONs that do not serialize the
    # "remat_policy" key. A non-default value shadowed by serialized
    # per-layer policies is inert and warns GLS103 (strategy_lint).
    remat_policy: str = "full"
    tp_comm_mode: str = "gspmd"  # TP_COMM_MODES: TP-collective execution path
    tp_comm_quant: str = "none"  # COMM_DTYPES: wire precision of the manual
    # TP ring payloads (parallel/tp_shard_map.py); requires a manual
    # tp_comm_mode — the compiler owns the gspmd collectives (GLS013).
    # Runtime knob like tp_comm_mode: NOT serialized.
    # Block size of the blockwise quantization (elements per absmax scale)
    # for every quantized collective. Serialized (the cost models price the
    # scale overhead through it).
    comm_quant_block: int = 64
    # Serving knobs (serve/): a serve-objective search records the KV-cache
    # geometry its memory/latency pricing assumed — max concurrent request
    # slots and the context-bucket page size. 0 = not a serve strategy;
    # serialized only when set so train-objective JSONs are unchanged. In
    # train mode these knobs are inert (GLS103).
    serve_max_concurrency: int = 0
    serve_page_size: int = 0
    # Shedding knobs (serve/engine.ContinuousBatcher admission control): the
    # p99 TTFT bound the predicted-TTFT shedder enforces and the pending-
    # queue depth bound. 0 = unset; like the geometry knobs, serialized only
    # when set and inert (GLS103) in train mode.
    serve_p99_ttft_ms: float = 0.0
    serve_max_pending: int = 0

    def __post_init__(self):
        if self.pp_division is None:
            self.pp_division = even_pp_division(len(self.layers), self.pp)
        self.validate()

    # ------------------------------------------------------------------ checks
    def structural_diagnostics(self) -> list:
        """Every structural check as a Diagnostic list (GLS002-GLS005,
        GLS010), so the CLI linter and the constructing `validate()` report
        identically. Checks degrade gracefully: a failed prerequisite (e.g.
        world % pp) skips the checks whose arithmetic it would poison rather
        than raising mid-collection."""
        out = []
        if self.default_dp_type not in DP_TYPES:
            out.append(D.make(
                "GLS005", "default_dp_type must be one of %s, got %r"
                % (DP_TYPES, self.default_dp_type), key="default_dp_type",
            ))
        if self.pipeline_type not in PIPELINE_TYPES:
            out.append(D.make(
                "GLS005", "pipeline_type must be one of %s, got %r"
                % (PIPELINE_TYPES, self.pipeline_type), key="pipeline_type",
            ))
        if self.cp_mode not in CP_MODES:
            out.append(D.make(
                "GLS005", "cp_mode must be one of %s, got %r"
                % (CP_MODES, self.cp_mode), key="cp_mode",
            ))
        if self.remat_policy not in REMAT_POLICIES:
            out.append(D.make(
                "GLS005", "remat_policy must be one of %s, got %r"
                % (REMAT_POLICIES, self.remat_policy), key="remat_policy",
                hint=D.did_you_mean(str(self.remat_policy), REMAT_POLICIES),
            ))
        if self.tp_comm_mode not in TP_COMM_MODES:
            out.append(D.make(
                "GLS005", "tp_comm_mode must be one of %s, got %r"
                % (TP_COMM_MODES, self.tp_comm_mode), key="tp_comm_mode",
                hint=D.did_you_mean(str(self.tp_comm_mode), TP_COMM_MODES),
            ))
        if self.tp_comm_quant not in COMM_DTYPES:
            out.append(D.make(
                "GLS005", "tp_comm_quant must be one of %s, got %r"
                % (COMM_DTYPES, self.tp_comm_quant), key="tp_comm_quant",
                hint=D.did_you_mean(str(self.tp_comm_quant), COMM_DTYPES),
            ))
        elif self.tp_comm_quant != "none" and self.tp_comm_mode == "gspmd":
            # the compiler owns the gspmd collectives: there is no ring
            # payload to quantize, and silently ignoring the knob would
            # break the never-silently-differ contract
            out.append(D.make(
                "GLS013", "tp_comm_quant=%r requires a manual tp_comm_mode "
                "(shard_map or overlap); gspmd collectives are compiler-"
                "derived and cannot carry a quantized ring payload"
                % self.tp_comm_quant, key="tp_comm_quant",
            ))
        if not isinstance(self.comm_quant_block, int) or self.comm_quant_block < 1:
            out.append(D.make(
                "GLS005", "comm_quant_block must be a positive int, got %r"
                % (self.comm_quant_block,), key="comm_quant_block",
            ))
        for k in ("serve_max_concurrency", "serve_page_size", "serve_max_pending"):
            sv = getattr(self, k)
            if not isinstance(sv, int) or sv < 0:
                out.append(D.make(
                    "GLS005", "%s must be a non-negative int, got %r" % (k, sv),
                    key=k,
                ))
        if (not isinstance(self.serve_p99_ttft_ms, (int, float))
                or isinstance(self.serve_p99_ttft_ms, bool)
                or self.serve_p99_ttft_ms < 0):
            out.append(D.make(
                "GLS005", "serve_p99_ttft_ms must be a non-negative number, "
                "got %r" % (self.serve_p99_ttft_ms,), key="serve_p99_ttft_ms",
            ))
        if self.pp < 1 or self.world_size % self.pp != 0:
            out.append(D.make(
                "GLS002", "world_size %d not divisible by pp %d"
                % (self.world_size, self.pp), key="pp_deg",
            ))
            return out  # per-stage arithmetic below would be meaningless
        if len(self.pp_division) != self.pp or sum(self.pp_division) != len(self.layers):
            out.append(D.make(
                "GLS003", "pp_division %s inconsistent with pp=%d, %d layers"
                % (self.pp_division, self.pp, len(self.layers)), key="pp_division",
            ))
        elif any(n < 1 for n in self.pp_division):
            out.append(D.make(
                "GLS003", "every pipeline stage needs >= 1 layer, got %s"
                % (self.pp_division,), key="pp_division",
            ))
        per_stage = self.world_size // self.pp
        dps = []
        for i, s in enumerate(self.layers):
            if per_stage % (s.tp * s.cp) != 0:
                out.append(D.make(
                    "GLS002", "layer %d: tp*cp=%d does not divide per-stage devices %d"
                    % (i, s.tp * s.cp, per_stage), layer=i,
                ))
            else:
                dps.append(per_stage // (s.tp * s.cp))
        if per_stage % (self.vocab_tp * self.vocab_cp) != 0:
            out.append(D.make(
                "GLS002", "vocab_tp*vocab_cp=%d must divide per-stage devices %d"
                % (self.vocab_tp * self.vocab_cp, per_stage), key="vtp",
            ))
        else:
            dps.append(per_stage // (self.vocab_tp * self.vocab_cp))
        # batch must divide every layer's dp degree (incl. the vocab layers):
        # the batch dim is sharded over each layer's dp axes (cf. reference
        # assert at hybrid_parallel_config.py:93-96, done there via min_tp)
        max_dp = max(dps) if dps else 1
        if self.global_bsz % max_dp != 0:
            out.append(D.make(
                "GLS004", "global_bsz %d must be a multiple of the largest "
                "layer dp degree %d" % (self.global_bsz, max_dp),
                key="global_bsz",
            ))
        # Under the 1F1B schedule the sharded unit is the MICROBATCH, and it
        # must shard EVENLY over every LAYER's dp degree: an uneven batch
        # shard makes GSPMD pad and reshard with collective-permutes, which
        # the schedule's stage-divergent branches cannot host (see
        # parallel/pipeline_1f1b.py divergence-safety invariant). The vocab
        # layers are exempt — embed/head run in the schedule's uniform
        # (non-branch) region, where padding reshards are safe — as are pp=1
        # and the gpipe scan (uniform code throughout).
        if self.pp > 1 and self.pipeline_type == "pipedream_flush":
            if self.global_bsz % self.chunks != 0:
                out.append(D.make(
                    "GLS004", "global_bsz %d must divide into %d chunks"
                    % (self.global_bsz, self.chunks), key="chunks",
                ))
            else:
                mb = self.global_bsz // self.chunks
                layer_dps = [
                    per_stage // (s.tp * s.cp) for s in self.layers
                    if per_stage % (s.tp * s.cp) == 0
                ]
                max_layer_dp = max(layer_dps) if layer_dps else 1
                if mb % max_layer_dp != 0:
                    out.append(D.make(
                        "GLS004", "1F1B microbatch size %d (global_bsz %d / "
                        "chunks %d) must be a multiple of the largest layer "
                        "dp degree %d"
                        % (mb, self.global_bsz, self.chunks, max_layer_dp),
                        key="chunks",
                    ))
        return out

    def validate(self):
        errors = [d for d in self.structural_diagnostics() if d.severity == D.ERROR]
        if errors:
            raise D.DiagnosticError(errors)

    # -------------------------------------------------------------- properties
    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def per_stage_devices(self) -> int:
        return self.world_size // self.pp

    def dp(self, layer_idx: int) -> int:
        s = self.layers[layer_idx]
        return self.per_stage_devices // (s.tp * s.cp)

    @property
    def stage_of_layer(self) -> List[int]:
        return pp_stage_of_layer(self.pp_division)

    def layers_of_stage(self, stage: int) -> List[int]:
        lo = sum(self.pp_division[:stage])
        return list(range(lo, lo + self.pp_division[stage]))

    def dp_type(self, layer_idx: int) -> str:
        return "zero3" if self.layers[layer_idx].fsdp else self.default_dp_type

    @property
    def max_cp(self) -> int:
        return max([s.cp for s in self.layers] + [self.vocab_cp])

    @property
    def microbatch_size(self) -> int:
        if self.global_bsz % self.chunks != 0:
            raise ValueError("global_bsz must divide evenly into chunks (pad upstream)")
        return self.global_bsz // self.chunks

    # ------------------------------------------------------------ constructors
    @classmethod
    def uniform(
        cls,
        world_size: int,
        num_layers: int,
        pp: int = 1,
        tp: int = 1,
        cp: int = 1,
        sp: int = 0,
        sdp: int = 0,
        checkpoint: int = 0,
        grad_comm_dtype: str = "none",
        param_comm_dtype: str = "none",
        remat_policy: str = "full",
        **kw,
    ) -> "HybridParallelConfig":
        """GLOBAL-mode config: one strategy for every layer (reference
        hybrid_parallel_config.py:27-42). The global ``remat_policy``
        default-override is stamped onto every layer here (there are no
        serialized per-layer values to defer to in GLOBAL mode)."""
        layer = LayerStrategy(tp=tp, cp=cp, sp=sp, fsdp=sdp, checkpoint=checkpoint,
                              grad_comm_dtype=grad_comm_dtype,
                              param_comm_dtype=param_comm_dtype,
                              remat_policy=remat_policy)
        return cls(world_size=world_size, pp=pp, layers=[layer] * num_layers,
                   remat_policy=remat_policy, **kw)

    @classmethod
    def from_json(cls, path_or_dict, world_size: int, **overrides) -> "HybridParallelConfig":
        """Load a searched strategy JSON in the reference's on-disk format
        (reference utils/config_utils.py:22-46). Rejects unknown/typo'd keys
        and malformed per-layer arrays with structured diagnostics (GLS001/
        GLS005/GLS006 via DiagnosticError) instead of silently ignoring them
        — a misspelled key would otherwise fall back to its default and
        surface minutes later as an OOM or a wrong-parallelism run."""
        cfg = path_or_dict if isinstance(path_or_dict, dict) else read_json_config(path_or_dict)
        schema_errors = [d for d in schema_diagnostics(cfg) if d.severity == D.ERROR]
        if schema_errors:
            raise D.DiagnosticError(schema_errors)
        tp_sizes = str2array(cfg["tp_sizes_enc"])
        n = len(tp_sizes)
        cp_sizes = str2array(cfg.get("cp_sizes_enc", array2str([1] * n)))
        consec = str2array(cfg.get("tp_consecutive_flags", array2str([1] * n)))
        dp_types = str2array(cfg["dp_types_enc"])
        use_sp = str2array(cfg.get("use_sp", array2str([0] * n)))
        ckpt = str2array(cfg.get("checkpoint", array2str([0] * n)))
        gcd = str2strlist(cfg["grad_comm_dtype"]) if "grad_comm_dtype" in cfg \
            else ["none"] * n
        pcd = str2strlist(cfg["param_comm_dtype"]) if "param_comm_dtype" in cfg \
            else ["none"] * n
        # precedence rule: serialized per-layer remat policies win; the
        # global --remat_policy flag (arriving as the remat_policy override)
        # only fills layers when the JSON does not carry the key
        rp_default = overrides.get("remat_policy", "full")
        rp = str2strlist(cfg["remat_policy"]) if "remat_policy" in cfg \
            else [rp_default] * n
        layers = [
            LayerStrategy(
                tp=tp_sizes[i], cp=cp_sizes[i], sp=use_sp[i], fsdp=dp_types[i],
                checkpoint=ckpt[i], tp_consec=consec[i],
                grad_comm_dtype=gcd[i], param_comm_dtype=pcd[i],
                remat_policy=rp[i],
            )
            for i in range(n)
        ]
        kw = dict(
            world_size=world_size,
            pp=cfg["pp_deg"],
            layers=layers,
            global_bsz=cfg.get("global_bsz", 8),
            chunks=cfg.get("chunks", 1),
            pp_division=str2array(cfg["pp_division"]) if "pp_division" in cfg else None,
            pipeline_type=cfg.get("pipeline_type", "gpipe"),
            default_dp_type=cfg.get("default_dp_type", "ddp"),
            vocab_tp=cfg.get("vtp", 1),
            vocab_sp=cfg.get("vsp", 0),
            vocab_cp=cfg.get("vcp", 1),
            embed_sdp=cfg.get("embed_sdp", 0),
            cp_mode=cfg.get("cp_mode", "zigzag"),
            comm_quant_block=cfg.get("comm_quant_block", 64),
            serve_max_concurrency=cfg.get("serve_max_concurrency", 0),
            serve_page_size=cfg.get("serve_page_size", 0),
            serve_p99_ttft_ms=cfg.get("serve_p99_ttft_ms", 0.0),
            serve_max_pending=cfg.get("serve_max_pending", 0),
        )
        kw.update(overrides)
        return cls(**kw)

    # ----------------------------------------------------------- serialization
    def to_json_dict(self) -> dict:
        """Reference-compatible JSON dict (utils/config_utils.py:48-57 plus the
        extra keys train_dist reads back)."""
        return {
            "pp_deg": self.pp,
            "tp_sizes_enc": array2str([s.tp for s in self.layers]),
            "tp_consecutive_flags": array2str([s.tp_consec for s in self.layers]),
            "cp_sizes_enc": array2str([s.cp for s in self.layers]),
            "dp_types_enc": array2str([s.fsdp for s in self.layers]),
            "use_sp": array2str([s.sp for s in self.layers]),
            "checkpoint": array2str([s.checkpoint for s in self.layers]),
            "global_bsz": self.global_bsz,
            "chunks": self.chunks,
            "pp_division": array2str(self.pp_division),
            "pipeline_type": self.pipeline_type,
            "default_dp_type": self.default_dp_type,
            "vtp": self.vocab_tp,
            "vsp": self.vocab_sp,
            "vcp": self.vocab_cp,
            "embed_sdp": self.embed_sdp,
            "cp_mode": self.cp_mode,
            "grad_comm_dtype": strlist2str([s.grad_comm_dtype for s in self.layers]),
            "param_comm_dtype": strlist2str([s.param_comm_dtype for s in self.layers]),
            "comm_quant_block": self.comm_quant_block,
        } | ({
            # serialized only when some layer deviates from "full": an
            # all-"full" key duplicates the checkpoint flag (GLS103) and
            # from_json default-fills it anyway, so round-trips stay clean
            "remat_policy": strlist2str([s.remat_policy for s in self.layers]),
        } if any(s.remat_policy != "full" for s in self.layers) else {}) | ({
            "serve_max_concurrency": self.serve_max_concurrency,
            "serve_page_size": self.serve_page_size,
        } if self.serve_max_concurrency or self.serve_page_size else {}) | ({
            "serve_p99_ttft_ms": self.serve_p99_ttft_ms,
        } if self.serve_p99_ttft_ms else {}) | ({
            "serve_max_pending": self.serve_max_pending,
        } if self.serve_max_pending else {})

    def save(self, path: str):
        write_json_config(self.to_json_dict(), path)
