"""``python -m galvatron_tpu_torch.cli lint``: static strategy and checkpoint analysis.

Port of ``galvatron_tpu/cli/lint.py``. Usage:

    # lint searched or hand-written strategy JSONs (no device work):
    python -m galvatron_tpu_torch.cli lint strategy.json --world_size 8 \
        --model_type llama --model_size llama-7b --memory_budget_gb 80

    # audit a checkpoint directory offline (manifests, provenance, the
    # embedded strategy; no tensor restored):
    python -m galvatron_tpu_torch.cli lint --ckpt ckpts/run42

    # ... and restore every step on the card to recompute its integrity
    # folds (GLS214; --device cpu for the CPU):
    python -m galvatron_tpu_torch.cli lint --ckpt ckpts/run42 --deep

Exit-code contract: 0 = clean (warnings allowed), 1 = at least one error
diagnostic, 2 = usage/IO failure. ``--json`` prints the machine-readable
report (``analysis/diagnostics.py`` `DiagnosticReport.to_json`);
``--strict`` upgrades warnings to the failing exit code; ``--explain``
prints the code table.

``--code`` (the jax-API drift linter, GLC), ``--trace`` (the jaxpr audit,
GLT) and ``--compat`` (the jax-workaround inventory, WA) analyse JAX
programs and sources; the port refuses each, and a ``.py`` path, with exit
2 and the ROADMAP entry where its counterpart waits (queue 1 items 12a and
12b).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from galvatron_tpu_torch.analysis import diagnostics as D

# the JAX-program analyses and where their counterparts wait
_JAX_ONLY = {
    "code": "--code lints Python sources for jax-API drift (GLC), which the port has no "
            "counterpart of: the decision on the GLC rules waits in ROADMAP queue 1 item 12b",
    "trace": "--trace audits the jaxpr of the train step (GLT): the port's collective audit "
             "(GLT101 / GLT102) waits in ROADMAP queue 1 item 12a, the decision on GLT001-006 "
             "in item 12b",
    "compat": "--compat inventories the installed jax's workarounds (WA), which the port has "
              "no counterpart of: the decision waits in ROADMAP queue 1 item 12b",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("galvatron_tpu_torch-lint", allow_abbrev=False)
    p.add_argument("paths", nargs="*", help="strategy .json files")
    p.add_argument("--code", action="store_true",
                   help="refused: the GLC code linter analyses JAX sources")
    p.add_argument("--ckpt", action="append", default=[], metavar="DIR",
                   help="audit a checkpoint directory offline (repeatable): "
                        "per-iteration manifest integrity, provenance "
                        "presence/consistency, embedded-strategy lint "
                        "(GLS21x; no tensor is restored)")
    p.add_argument("--deep", action="store_true",
                   help="with --ckpt: restore every step into a world-1 model on --device "
                        "and verify its layout-invariant integrity folds against the "
                        "manifest (GLS214): catches bit rot between save and resume at "
                        "the cost of reading the checkpoint")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="where --deep rebuilds the model and folds the state (the fold "
                        "kernel on cuda, its plain version on cpu)")
    p.add_argument("--json", dest="as_json", action="store_true",
                   help="machine-readable JSON output")
    p.add_argument("--strict", action="store_true",
                   help="exit non-zero on warnings too")
    p.add_argument("--explain", action="store_true",
                   help="print the diagnostic-code table and exit")
    p.add_argument("--world_size", type=int,
                   default=int(os.environ.get("GALVATRON_WORLD_SIZE", "8")),
                   help="device count the strategy must tile (default: "
                        "$GALVATRON_WORLD_SIZE or 8)")
    p.add_argument("--model_type", type=str, default=None,
                   help="model family for model-aware checks (heads/seq/vocab "
                        "divisibility, memory estimate)")
    p.add_argument("--model_size", type=str, default=None)
    p.add_argument("--memory_budget_gb", type=float, default=None,
                   help="memory budget per GPU; enables the GLS101 estimate")
    p.add_argument("--memory_profile", type=str, default=None,
                   help="profiled memory JSON (profiler schema) to back the "
                        "GLS101 estimate instead of the analytic tables")
    p.add_argument("--serve", action="store_true",
                   help="lint strategy JSONs for serve-mode feasibility "
                        "(GLS014: decode-incompatible layouts, KV-cache "
                        "budget when --memory_budget_gb is given)")
    p.add_argument("--trace", action="store_true",
                   help="refused: the GLT trace linter audits JAX programs")
    p.add_argument("--compat", action="store_true",
                   help="refused: the WA inventory probes the installed jax")
    t = p.add_argument_group("model-dim overrides (model-aware GLS checks)")
    t.add_argument("--num_layers", type=int, default=None)
    t.add_argument("--hidden_size", type=int, default=None)
    t.add_argument("--num_heads", type=int, default=None)
    t.add_argument("--seq_length", type=int, default=None)
    t.add_argument("--vocab_size", type=int, default=None)
    return p


def _model_cfg(args):
    if not args.model_type:
        return None
    from galvatron_tpu_torch.models.registry import get_family

    fam = get_family(args.model_type)
    overrides = {key: getattr(args, flag) for flag, key in (
        ("num_layers", "num_layers"), ("hidden_size", "hidden_size"),
        ("num_heads", "num_heads"), ("seq_length", "max_seq_len"),
        ("vocab_size", "vocab_size")) if getattr(args, flag) is not None}
    return fam.config_fn(args.model_size or fam.default_size, **overrides)


def run(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.explain:
        print(D.registry_table())
        return 0
    refused = [flag for flag in _JAX_ONLY if getattr(args, flag)]
    code_paths = [p for p in args.paths if not p.endswith(".json")]
    if refused or code_paths:
        for flag in refused:
            print("lint: %s" % _JAX_ONLY[flag], file=sys.stderr)
        if code_paths:
            print("lint: %s: %s" % (", ".join(code_paths), _JAX_ONLY["code"]), file=sys.stderr)
        return 2
    json_paths = list(args.paths)
    if not json_paths and not args.ckpt:
        print("nothing to lint: pass strategy .json paths or --ckpt dirs", file=sys.stderr)
        return 2
    try:
        model_cfg = _model_cfg(args)
    except (KeyError, ValueError, TypeError) as e:
        print("bad --model_type/--model_size: %s" % e, file=sys.stderr)
        return 2

    report = D.DiagnosticReport()
    if json_paths:
        from galvatron_tpu_torch.analysis import strategy_lint as S
        from galvatron_tpu_torch.utils.jsonio import read_json_config

        memory_profile = None
        if args.memory_profile:
            try:
                memory_profile = read_json_config(args.memory_profile)
            except (OSError, ValueError) as e:
                print("cannot read --memory_profile: %s" % e, file=sys.stderr)
                return 2
        for path in json_paths:
            try:
                report.extend(S.lint_strategy_file(
                    path, args.world_size, model_cfg=model_cfg,
                    memory_budget_gb=args.memory_budget_gb, memory_profile=memory_profile,
                    mode="serve" if args.serve else None).diagnostics)
            except (OSError, ValueError) as e:
                print("cannot lint %s: %s" % (path, e), file=sys.stderr)
                return 2
    for ckpt_dir in args.ckpt:
        if not os.path.isdir(ckpt_dir):
            print("cannot audit %s: not a directory" % ckpt_dir, file=sys.stderr)
            return 2
    if args.ckpt:
        from galvatron_tpu_torch.analysis import ckpt_lint as K

        if args.deep:
            from galvatron_tpu_torch.runtime import distributed

            with distributed.process_group(args.device) as device:
                for ckpt_dir in args.ckpt:
                    report.extend(K.audit_checkpoint_dir(ckpt_dir, deep=True,
                                                         device=device).diagnostics)
        else:
            for ckpt_dir in args.ckpt:
                report.extend(K.audit_checkpoint_dir(ckpt_dir).diagnostics)

    print(report.to_json() if args.as_json else report.render())
    if args.strict and report.warnings:
        return 1
    return report.exit_code()


def main(argv: Optional[List[str]] = None) -> None:
    rc = run(argv)
    if rc:
        sys.exit(rc)
