"""Strategy lint (``GLS***`` diagnostics) for the serve and train entry points.

Port of what ``galvatron_tpu/analysis/strategy_lint.lint_hp`` reports
without a cost model on layouts of world size 1: the structural errors
(shared with ``HybridParallelConfig.validate``), the runnable-but-odd
warnings (GLS103: inert pipeline type, tp_comm_mode, shadowed remat
policy), in serve mode the GLS014 refusals of layouts a decode engine
cannot realise (pp>1, ring cp, Ulysses sp), and in train mode the GLS103
warnings on serve knobs and comm dtypes that cannot act. A strategy the
reference refuses is refused here with the same codes, before any model is
built. The checks that only fire on tp/cp/sp or vocab-parallel layouts
(GLS007-009 divisibility, GLS102 resharding, Ulysses sp at tp=1) come with
the slice that runs those layouts; the memory-budget check (GLS101) and the
manual-TP and quantized-collective refusals with the slices that port the
cost models and those paths.
"""

from __future__ import annotations

from typing import List, Optional

from galvatron_tpu_torch.analysis import diagnostics as D
from galvatron_tpu_torch.config.strategy import HybridParallelConfig


def _serve_diagnostics(hp: HybridParallelConfig) -> List[D.Diagnostic]:
    """GLS014: layouts a decode engine cannot realise."""
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
    return out


def _warning_diagnostics(hp: HybridParallelConfig) -> List[D.Diagnostic]:
    """GLS103: runnable but almost certainly not what was meant."""
    out: List[D.Diagnostic] = []
    if hp.pp == 1 and hp.pipeline_type == "pipedream_flush":
        out.append(D.make("GLS103", "pipeline_type='pipedream_flush' with pp=1 runs the "
                          "plain single-stage path; the flag is inert", key="pipeline_type"))
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


def lint_hp(
    hp: HybridParallelConfig,
    file: Optional[str] = None,
    mode: Optional[str] = None,
) -> D.DiagnosticReport:
    """Lint an already-constructed config: structural checks, the GLS103
    warnings, plus the GLS014 serve-feasibility layer when ``mode="serve"``
    and the train-mode GLS103 warnings when ``mode="train"``."""
    report = D.DiagnosticReport()
    report.extend(hp.structural_diagnostics())
    report.extend(_warning_diagnostics(hp))
    if mode == "serve":
        report.extend(_serve_diagnostics(hp))
    elif mode == "train":
        report.extend(_train_diagnostics(hp))
    if file:
        report.diagnostics = [
            D.Diagnostic(**{**d.__dict__, "file": d.file or file})
            for d in report.diagnostics
        ]
    return report
