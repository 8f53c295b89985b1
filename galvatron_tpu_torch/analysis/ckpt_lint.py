"""Offline checkpoint auditor (``GLS21x`` diagnostics).

Port of ``galvatron_tpu/analysis/ckpt_lint.py`` for the port's checkpoint
layout (``runtime/checkpoint.py``): ``<it>/rank<r>.pt``,
``<it>/train_meta.json``, ``manifests/<it>.json``,
``hybrid_parallel_config.json`` and ``meta.json``.
``python -m galvatron_tpu_torch.cli lint --ckpt <dir>`` checks a checkpoint
directory without restoring any tensor (host-only, seconds for any size):

- every step on disk has a committed, well-formed manifest (GLS210 torn /
  GLS212 malformed) whose item records carry the ``spec_digest`` /
  ``num_leaves`` the restore-time verifier needs;
- orphan manifests and stray entries are flagged (GLS211);
- manifests carry provenance (GLS213 when missing: resumable only on the
  identical strategy), whose strategy JSON lints clean against its own
  recorded world size (the GLS0xx rules of ``analysis/strategy_lint.py``)
  and whose bookkeeping is self-consistent (GLS212);
- with ``--deep`` (the one exception to the host-only rule) each step is
  restored and its layout-invariant folds recomputed against the
  manifest's (GLS214): bytes that changed between save and now (bit rot, a
  partial overwrite), found before a resume bets on them. The saved model
  is rebuilt from ``meta.json``'s ``model_config`` (GLS213 for a
  directory that predates it), held to the provenance's model digest
  (GLS212), at world 1 on `device`;
  the port's elastic reader (``runtime/checkpoint.SavedShards``: the saved
  ranks' files memory-mapped, each leaf copied from the regions that hold
  it) fills it one leaf at a time, reading the bytes as they are (no
  sha256 verification first), and ``runtime/sdc.state_fold`` folds the
  params, then the params with the Adam state: two launches of the fold
  kernel (``csrc/tree_fold.cu``) per step on the card, its plain version
  on the CPU. An item without a recorded ``fold`` gives GLS213.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from galvatron_tpu_torch.analysis import diagnostics as D

# directory entries that belong to the checkpoint layout besides the
# integer-named step dirs
_KNOWN_ENTRIES = ("manifests", "hybrid_parallel_config.json", "meta.json")
_REQUIRED_ITEM_KEYS = ("spec_digest", "num_leaves")


def _provenance_diagnostics(step: int, prov: Dict[str, Any]) -> List[D.Diagnostic]:
    out: List[D.Diagnostic] = []
    strategy = prov.get("strategy")
    world = prov.get("world_size")
    if not isinstance(strategy, dict) or not isinstance(world, int):
        out.append(D.make(
            "GLS212", "step %d provenance lacks a strategy dict / integer "
            "world_size — not elastically resumable" % step))
        return out
    mesh_shape = prov.get("mesh_shape")  # the reference's key; the port's ranks are its devices
    if isinstance(mesh_shape, dict):
        n = 1
        for v in mesh_shape.values():
            n *= int(v)
        if n != world:
            out.append(D.make(
                "GLS212", "step %d provenance mesh_shape %s covers %d "
                "devices but world_size says %d" % (step, mesh_shape, n, world)))
    if not prov.get("model_digest"):
        out.append(D.make(
            "GLS212", "step %d provenance has no model_digest; an elastic "
            "resume could silently restore into a different model" % step))
    from galvatron_tpu_torch.analysis import strategy_lint as S

    for d in S.lint_strategy_dict(dict(strategy), world).diagnostics:
        out.append(D.Diagnostic(**{
            **d.__dict__, "message": "step %d provenance strategy: %s" % (step, d.message)}))
    return out


def _saved_model_config(path: str):
    """The saved model's config, rebuilt from ``meta.json``'s record, or
    (None, why)."""
    from galvatron_tpu_torch.runtime.provenance import model_config_from_fields

    try:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        fields = meta["model_config"]
    except (OSError, ValueError, KeyError) as e:
        return None, "%s: %s" % (type(e).__name__, e)
    return model_config_from_fields(meta["model_type"], meta.get("model_size"), fields), None


def _deep_step_diagnostics(path: str, step: int, manifest: Dict[str, Any], add,
                           device, cfg: Any) -> None:
    """``--deep``: restore `step` into a world-1 model on `device` and
    recompute its layout-invariant folds against the manifest's records
    (GLS214 on a mismatch: the bytes changed since the save)."""
    import torch

    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.runtime import checkpoint as ck
    from galvatron_tpu_torch.runtime import sdc
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
    from galvatron_tpu_torch.runtime.provenance import model_config_digest

    items = manifest["items"]
    want = {}
    for name in ("params", "opt_state"):
        if name not in items:
            continue
        if items[name].get("fold") is None:
            add("GLS213", "step %d item %r predates the integrity fold; the deep audit "
                "cannot verify its values" % (step, name))
        else:
            want[name] = int(items[name]["fold"]) & sdc._MASK32
    if not want:
        return
    if model_config_digest(cfg) != manifest["provenance"].get("model_digest"):
        add("GLS212", "step %d: meta.json's model config does not have the provenance's "
            "model_digest; the deep audit cannot rebuild the saved model" % step)
        return
    try:
        saved_hp = ck._saved_strategy(manifest, path, step)
        files = {r: ck._read_rank(path, step, r) for r in range(saved_hp.world_size)}
        saved = ck.SavedShards(files, saved_hp, cfg)
        hp = HybridParallelConfig.uniform(1, saved_hp.num_layers, global_bsz=1)
        target = construct_hybrid_parallel_model(cfg, hp, device)
        params = target.empty_params()
        opt_state = target.init_opt_state(None, params) if "opt_state" in want else None
        saved.fill_target(target, params, opt_state, "checkpoint %s step %d" % (path, step))
    except (OSError, RuntimeError, ValueError, KeyError, EOFError) as e:
        add("GLS212", "step %d failed to restore for the deep audit (%s: %s)"
            % (step, type(e).__name__, e))
        return
    got = {"params": sdc.state_fold(target, params)}
    if opt_state is not None:
        got["opt_state"] = sdc.state_fold(target, params, opt_state)
    del params, opt_state, saved, files
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    for name in sorted(want):
        if got[name] != want[name]:
            add("GLS214", "step %d item %r: recomputed integrity fold 0x%08x != manifest "
                "0x%08x — the checkpoint bytes changed since save"
                % (step, name, got[name], want[name]))


def audit_checkpoint_dir(path: str, deep: bool = False, device: Any = "cuda"
                         ) -> D.DiagnosticReport:
    """Audit one checkpoint directory. `deep` additionally restores every
    step on `device` and verifies its integrity folds (GLS214): no longer
    host-metadata-only, so it costs a full read of the checkpoint. The
    caller of a deep audit on cuda enters
    ``runtime.distributed.process_group`` (the world-1 model's groups)."""
    from galvatron_tpu_torch.runtime import checkpoint as ck

    report = D.DiagnosticReport()

    def add(code, msg, **kw):
        kw.setdefault("file", path)
        report.add(D.make(code, msg, **kw))

    if not os.path.isdir(path):
        add("GLS212", "not a directory")
        return report
    steps = ck.all_iterations(path)
    manifest_steps = set()
    mdir = os.path.join(path, ck.MANIFEST_DIRNAME)
    if os.path.isdir(mdir):
        for name in sorted(os.listdir(mdir)):
            stem = name.split(".")[0]
            if name.endswith(".json") and stem.isdigit():
                manifest_steps.add(int(stem))
            elif not name.endswith(".json"):
                add("GLS211", "stray entry %r in %s/" % (name, ck.MANIFEST_DIRNAME))
    has_discipline = bool(manifest_steps) or os.path.isdir(mdir)
    # stray entries in the top-level dir (an interrupted tmp file, editor
    # droppings): tolerated by every runtime path, but worth surfacing
    for name in sorted(os.listdir(path)):
        if name in _KNOWN_ENTRIES or name.isdigit():
            continue
        add("GLS211", "stray entry %r in the checkpoint dir" % name)
    if not steps:
        add("GLS211", "no checkpoint steps on disk")
    cfg = None
    if deep and steps:
        cfg, why = _saved_model_config(path)
        if cfg is None:
            add("GLS213", "meta.json predates the model config record (%s): the deep audit "
                "cannot rebuild the saved model" % why)
    for step in steps:
        if not has_discipline:
            add("GLS213", "step %d predates the manifest discipline (no "
                "integrity verification possible)" % step)
            continue
        manifest = ck.read_manifest(path, step)
        if manifest is None:
            add("GLS210", "step %d has no committed manifest (torn or "
                "interrupted save)" % step)
            continue
        if manifest.get("iteration") != step:
            add("GLS212", "step %d manifest records iteration %r"
                % (step, manifest.get("iteration")))
        items = manifest.get("items")
        items_ok = isinstance(items, dict) and "params" in items
        if not items_ok:
            add("GLS212", "step %d manifest has no 'params' item record" % step)
        else:
            for name, rec in sorted(items.items()):
                missing = [k for k in _REQUIRED_ITEM_KEYS if not rec.get(k)]
                if missing:
                    add("GLS212", "step %d item %r record lacks %s"
                        % (step, name, ", ".join(missing)))
        prov = manifest.get("provenance")
        if prov is None:
            add("GLS213", "step %d manifest has no provenance (resumable "
                "only on the identical mesh/strategy)" % step)
        else:
            for d in _provenance_diagnostics(step, prov):
                report.add(D.Diagnostic(**{**d.__dict__, "file": d.file or path}))
        if deep and items_ok and cfg is not None:
            if prov is None:
                add("GLS213", "step %d: the deep audit needs the provenance's strategy and "
                    "model digest to rebuild the saved model" % step)
            else:
                _deep_step_diagnostics(path, step, manifest, add, device, cfg)
    for orphan in sorted(manifest_steps - set(steps)):
        add("GLS211", "manifest for step %d has no step directory (GC race "
            "leftover?)" % orphan)
    return report
