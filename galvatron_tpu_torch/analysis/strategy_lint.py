"""Serve-mode strategy lint (``GLS***`` diagnostics).

Port of what ``galvatron_tpu/analysis/strategy_lint.lint_hp(..., mode=
"serve")`` reports on the serve path: the structural errors (shared with
``HybridParallelConfig.validate``) and the GLS014 refusals of layouts a
decode engine cannot realise (pp>1, ring cp, Ulysses sp). A strategy the
reference refuses for serving is refused here with the same codes, before
any model is built. The cost-model-backed warnings and the train-mode
checks come with the slices that port the search engine and the trainer.
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


def lint_hp(
    hp: HybridParallelConfig,
    file: Optional[str] = None,
    mode: Optional[str] = None,
) -> D.DiagnosticReport:
    """Lint an already-constructed config: structural checks, plus the
    GLS014 serve-feasibility layer when ``mode="serve"``."""
    report = D.DiagnosticReport()
    report.extend(hp.structural_diagnostics())
    if mode == "serve":
        report.extend(_serve_diagnostics(hp))
    if file:
        report.diagnostics = [
            D.Diagnostic(**{**d.__dict__, "file": d.file or file})
            for d in report.diagnostics
        ]
    return report
