"""Sharded checkpoint save / resume with torn-write detection.

Port of ``galvatron_tpu/runtime/checkpoint.py``. Every rank writes only its
own shards — ZeRO-3 parameters, ZeRO-2 moments, TP and vocab-TP slices, each
as the rank holds it — with ``torch.save``; nothing is gathered to rank 0.
Layout under ``<dir>/`` (the reference's):

    hybrid_parallel_config.json      the strategy of the newest save
    meta.json                        model family, size and config fields
                                     (``model_config``), world size
    <iteration>/rank<r>.pt           rank r's params and Adam state
    <iteration>/train_meta.json      scalar train metadata
    manifests/<iteration>.json       the integrity manifest (below)

Integrity manifest
------------------
The manifest is the commit record: rank 0 writes it atomically (a tmp file,
then ``os.replace``) only after every rank has finished writing, so a step
directory without a manifest is torn. Per item (``params``, ``opt_state``,
``train_meta``) it records

    ``digest``       sha256 over every leaf's (name, dtype, shape, sha256 of
                     its bytes), leaves in sorted name order, folded over
                     the ranks in rank order;
    ``spec_digest``  the same over (name, dtype, shape) only;
    ``num_leaves``   the leaf count (all ranks);
    ``ranks``        the three of them per rank.

The leaves' own sha256s run on a thread pool (hashlib releases the GIL), so
a digest of many GB costs about one pass over the bytes per core.
``opt_state`` leaves are ``count``, ``mu/<name>`` and ``nu/<name>``. The
manifest also carries the provenance block (``runtime/provenance.py``).

`load_checkpoint` verifies each rank's bytes against its manifest record
before they reach the model: a missing manifest (GLS210) or a digest
mismatch (GLS214) marks the step torn (every step has a manifest once it
committed: there is no other kind of directory), and — unless an iteration was named —
the restore falls back to the newest intact step (every rank agreeing on
the verdict). The strategy guard refuses a checkpoint of another strategy
or world size with GLS206, another model with GLS201 and another optimizer
tree with GLS202. `load_full_params` / `load_full_state` assemble the full
parameters (and Adam state) of a checkpoint of any world size and strategy
in one process (``cli serve --load``).

Across strategies (``load_checkpoint(..., target=model, allow_cross=True)``,
what ``cli train --elastic`` calls): the saved strategy comes from the
step's provenance (GLS204 without one); each saved rank's file is verified
against its manifest record by one process; then every process fills each
shard of its live params and of both Adam moments (ZeRO-2 moment shards
included) from the regions of the saved ranks' memory-mapped files that
overlap it (`SavedShards`), reading no other bytes. Last, the port's form
of the reference's digest-continuity check (GLS016): the live leaves,
gathered one at a time and cut again under the saved strategy, must
reproduce every saved rank's manifest record. A step of the model's own
strategy takes the plain path.

Under a pipeline each rank's file holds its stage's shards under their
global names (``layers.<i>...``); the last stage leaves out its copy of a
tied table, which the first stage's file holds
(``HybridParallelModel.checkpoint_view``; ``restore_tied`` refills the copy
after a load), so `load_full_params` reassembles the canonical layer list
from the stages' files. A resume under another pp or division is another
strategy (GLS206 on a plain resume; renaming for the cross-strategy
restore, since stage files key layers by their global index).

Saving is collective. Each rank's own write (its file, and rank 0's
directory set-up and manifest) is retried under the caller's
``RetryPolicy``, and every round's outcome is gathered, so all ranks retry
together and raise together: a rank never re-enters a collective the
others have left.

Retention: `gc_checkpoints` (``--keep_latest_k``) deletes the oldest steps
and their manifests, never a step being restored (``_RESTORING``) nor the
newest intact step, and tolerates stray directories.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from galvatron_tpu_torch.analysis import diagnostics as D
from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.obs import telemetry
from galvatron_tpu_torch.runtime.optimizer import AdamState
from galvatron_tpu_torch.utils.jsonio import write_json_config

MANIFEST_DIRNAME = "manifests"

# test seam: called after every rank's write, before the manifest commit —
# the torn-save window a preemption kill hits
_before_manifest_write = None


def _write_rank_file(host: Dict[str, Any], path: str) -> None:
    """One rank's write of its shards (a test seam for write faults)."""
    torch.save(host, path)

# steps currently being restored: gc_checkpoints never deletes one
_RESTORING: set = set()
_RESTORING_LOCK = threading.Lock()


class CheckpointIntegrityError(D.DiagnosticError, RuntimeError):
    """A requested checkpoint step failed its integrity check (GLS210 /
    GLS212 / GLS214)."""


# ------------------------------------------------------------- collectives
def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier():
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _gather(obj) -> list:
    """Every rank's `obj`, in rank order."""
    rank, world = _world()
    if world == 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def _agreed(fn, policy, counters, description: str):
    """Run the rank-local `fn` on every rank until it has succeeded on all
    of them. A rank whose attempt failed retries it under `policy` (a
    ``runtime.resilience.RetryPolicy``; None: no retry); the others only
    wait. Each round's outcome, the time spent and rank 0's jitter draw are
    gathered, so every rank takes the same decision to retry, back off as
    long, or raise."""
    import random

    from galvatron_tpu_torch.runtime import resilience as rsl

    policy = policy or rsl.RetryPolicy(retries=0)
    rank, _ = _world()
    t0, attempt, done, mine = time.monotonic(), 0, False, None
    while True:
        err = None
        if not done:
            try:
                fn()
                done = True
            except policy.retryable as e:
                mine, err = e, "%s: %s" % (type(e).__name__, e)
        rounds = _gather((err, time.monotonic() - t0, random.random()))
        failed = {r: e for r, (e, _, _) in enumerate(rounds) if e is not None}
        if not failed:
            if attempt and counters is not None:
                counters.retries_succeeded += 1
            return
        delay = min(policy.base_delay_s * policy.multiplier ** attempt, policy.max_delay_s)
        if policy.jitter:
            delay *= rounds[0][2]
        elapsed = max(t for _, t, _ in rounds)
        if attempt >= policy.retries or (policy.max_elapsed_s is not None
                                         and elapsed + delay > policy.max_elapsed_s):
            if counters is not None:
                counters.retries_exhausted += 1
            if rank in failed:
                raise mine
            raise OSError("%s failed on rank(s) %s: %s" % (
                description, sorted(failed), "; ".join(failed.values())))
        if counters is not None:
            counters.retries += 1
        if rank == 0:
            print("resilience: %s failed on rank(s) %s (%s); retry %d/%d in %.2fs"
                  % (description, sorted(failed), "; ".join(failed.values()), attempt + 1,
                     policy.retries, delay))
        telemetry.emit("retry", description=description, attempt=attempt + 1,
                       error="; ".join(failed.values()), delay_s=delay)
        time.sleep(delay)
        attempt += 1


def _from_rank0(obj):
    _, world = _world()
    if world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


# ----------------------------------------------------------------- leaves
def _param_leaves(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return {n: p.detach() for n, p in params.named_parameters()}
    return {n: t.detach() for n, t in params.items()}


def _opt_leaves(state: AdamState) -> Dict[str, torch.Tensor]:
    out = {"count": torch.tensor(int(state.count), dtype=torch.int64)}
    out.update({"mu/" + n: t.detach() for n, t in state.mu.items()})
    out.update({"nu/" + n: t.detach() for n, t in state.nu.items()})
    return out


def _to_host(leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Host tensors that own exactly their bytes (torch.save writes a view's
    whole storage, so a view of a larger buffer is cloned)."""
    out = {}
    for n, t in leaves.items():
        t = t.to("cpu").contiguous()
        if t.untyped_storage().nbytes() != t.numel() * t.element_size():
            t = t.clone()
        out[n] = t
    return out


def _leaf_sha(t: torch.Tensor) -> str:
    h = hashlib.sha256()
    h.update(t.reshape(-1).view(torch.uint8).numpy().data)
    return h.hexdigest()


def tree_digests(leaves: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The manifest record of one rank's item: value digest, structure
    digest and leaf count over host tensors (see the module note)."""
    names = sorted(leaves)
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        shas = list(ex.map(lambda n: _leaf_sha(leaves[n]), names))
    return _fold_leaves({n: (str(leaves[n].dtype), tuple(leaves[n].shape), sha)
                         for n, sha in zip(names, shas)})


def _fold_leaves(leaves: Mapping[str, Tuple[str, tuple, str]]) -> Dict[str, Any]:
    """A manifest record from each leaf's (dtype, shape, sha256)."""
    value, spec = hashlib.sha256(), hashlib.sha256()
    for n in sorted(leaves):
        dtype, shape, sha = leaves[n]
        key = (n + dtype + str(tuple(shape))).encode()
        spec.update(key)
        value.update(key + sha.encode())
    return {"digest": value.hexdigest(), "spec_digest": spec.hexdigest(),
            "num_leaves": len(leaves)}


def _meta_digest(meta: Dict[str, Any]) -> Dict[str, Any]:
    d = hashlib.sha256(json.dumps(meta, sort_keys=True).encode()).hexdigest()
    return {"digest": d, "spec_digest": d, "num_leaves": 1}


def _fold(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One item's record over every rank's (rank order)."""
    def cat(key):
        return hashlib.sha256("".join(r[key] for r in records).encode()).hexdigest()
    return {"digest": cat("digest"), "spec_digest": cat("spec_digest"),
            "num_leaves": sum(r["num_leaves"] for r in records), "ranks": records}


def state_digests(params, opt_state: Optional[AdamState] = None) -> Dict[str, Dict[str, Any]]:
    """This rank's manifest records of live state (copied to the host):
    what `save_checkpoint` would write into ``ranks[rank]``."""
    out = {"params": tree_digests(_to_host(_param_leaves(params)))}
    if opt_state is not None:
        out["opt_state"] = tree_digests(_to_host(_opt_leaves(opt_state)))
    return out


# ----------------------------------------------------------------- manifests
def _step_dir(ckpt_dir: str, iteration: int) -> str:
    return os.path.join(ckpt_dir, str(int(iteration)))


def _manifest_path(ckpt_dir: str, iteration: int) -> str:
    return os.path.join(ckpt_dir, MANIFEST_DIRNAME, "%d.json" % iteration)


def _rank_file(ckpt_dir: str, iteration: int, rank: int) -> str:
    return os.path.join(_step_dir(ckpt_dir, iteration), "rank%d.pt" % rank)


def _write_manifest(ckpt_dir: str, iteration: int, items: Dict[str, Dict[str, Any]],
                    world: int, provenance: Optional[Dict[str, Any]] = None) -> None:
    path = _manifest_path(ckpt_dir, iteration)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"format": 1, "iteration": iteration, "saved_at": time.time(),
               "world_size": world, "items": items}
    if provenance is not None:
        payload["provenance"] = provenance
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic commit: manifest exists => save completed


def _read_manifest_raising(ckpt_dir: str, iteration: int) -> Optional[Dict[str, Any]]:
    """Like read_manifest, but lets OSErrors propagate so a caller can put a
    retry policy around the read; only a missing file returns None."""
    path = _manifest_path(ckpt_dir, iteration)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def read_manifest(ckpt_dir: str, iteration: int) -> Optional[Dict[str, Any]]:
    try:
        return _read_manifest_raising(ckpt_dir, iteration)
    except (OSError, ValueError):
        return None  # a torn manifest marks the step torn too


def read_provenance(ckpt_dir: str, iteration: Optional[int] = None):
    """(iteration, provenance) of the requested (or newest intact) step;
    (None, None) when no manifest carries provenance."""
    if iteration is not None:
        prov = (read_manifest(ckpt_dir, iteration) or {}).get("provenance")
        return (iteration, prov) if prov else (None, None)
    for step in reversed(intact_iterations(ckpt_dir)):
        m = read_manifest(ckpt_dir, step)
        if m and m.get("provenance"):
            return step, m["provenance"]
    return None, None


# ------------------------------------------------------------------- listing
def all_iterations(ckpt_dir: str) -> List[int]:
    """Step directories on disk (torn or not), ascending; stray entries are
    ignored."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n) for n in os.listdir(ckpt_dir)
                  if n.isdigit() and os.path.isdir(os.path.join(ckpt_dir, n)))


def latest_iteration(ckpt_dir: str) -> Optional[int]:
    steps = all_iterations(ckpt_dir)
    return steps[-1] if steps else None


def intact_iterations(ckpt_dir: str) -> List[int]:
    """Saved steps whose manifest committed, ascending; the others are
    torn."""
    return [s for s in all_iterations(ckpt_dir) if read_manifest(ckpt_dir, s) is not None]


# ---------------------------------------------------------------------- save
def save_checkpoint(
    ckpt_dir: str,
    iteration: int,
    params: Any,
    opt_state: Optional[AdamState] = None,
    hp: Optional[HybridParallelConfig] = None,
    train_meta: Optional[Dict[str, Any]] = None,
    keep_latest_k: Optional[int] = None,
    provenance: Optional[Dict[str, Any]] = None,
    meta: Optional[Dict[str, Any]] = None,
    retry_policy: Any = None,
    counters: Any = None,
    rank_views: Optional[Dict[int, Tuple[Any, Optional[AdamState]]]] = None,
    folds: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Write this rank's params (a module or name -> tensor) and Adam state
    at `iteration`, commit the manifest after every rank has written, then
    GC to the newest `keep_latest_k`. Collective under a process group of
    more than one rank: the writes are retried under `retry_policy`
    (``counters`` counts the retries) with every rank agreeing, see
    `_agreed`. A process that hosts every stage of a pipeline (one device
    each, ``LocalTransport``) passes `rank_views` instead: {strategy rank:
    (params, Adam state)} of every hosted stage
    (``HybridParallelModel.checkpoint_views``), written as the files of a
    world of ``len(rank_views)``. Returns {"bytes", "seconds", "digest_s",
    "write_s", "items"} of this rank's part (of the first hosted rank's
    with `rank_views`, and "ranks": every hosted rank's items). `folds`
    ({"params": fold, "opt_state": fold}, ``runtime/sdc.state_fold`` of the
    live state, which the train CLI computes at every save) goes into the
    items' records as ``fold``: the layout-invariant digest a restore under
    any strategy can be held to (`load_checkpoint(..., sdc_check=True)`)."""
    t0 = time.perf_counter()
    rank, world = _world()
    if rank_views is None:
        rank_views = {rank: (params, opt_state)}
    elif world != 1:
        raise ValueError("rank_views: one process writes every rank's file only in a "
                         "process group of one (a hosted pipeline)")
    else:
        world = len(rank_views)
    step_dir = _step_dir(ckpt_dir, iteration)

    def set_up():
        if rank != 0:
            return
        os.makedirs(os.path.join(ckpt_dir, MANIFEST_DIRNAME), exist_ok=True)
        if hp is not None:
            write_json_config(hp.to_json_dict(),
                              os.path.join(ckpt_dir, "hybrid_parallel_config.json"))
        write_json_config(dict(meta or {}, world_size=world), os.path.join(ckpt_dir, "meta.json"))
        if os.path.isdir(step_dir):
            # re-save of an existing step (e.g. after a rollback): replace it
            # wholesale, its manifest first
            try:
                os.remove(_manifest_path(ckpt_dir, iteration))
            except FileNotFoundError:
                pass
            shutil.rmtree(step_dir)
        os.makedirs(step_dir)

    def write():
        for r, host in hosts.items():
            _write_rank_file(host, _rank_file(ckpt_dir, iteration, r))
        if rank == 0 and train_meta:
            write_json_config(train_meta, os.path.join(step_dir, "train_meta.json"))

    def commit():
        if rank == 0:
            _write_manifest(ckpt_dir, iteration, items, world, provenance=provenance)

    _agreed(set_up, retry_policy, counters, "checkpoint set-up")
    hosts = {}
    for r, (p, o) in sorted(rank_views.items()):
        hosts[r] = {"params": _to_host(_param_leaves(p))}
        if o is not None:
            hosts[r]["opt_state"] = _to_host(_opt_leaves(o))
    t1 = time.perf_counter()
    mine = {r: {name: tree_digests(leaves) for name, leaves in host.items()}
            for r, host in hosts.items()}
    t2 = time.perf_counter()
    _agreed(write, retry_policy, counters, "checkpoint write")
    t3 = time.perf_counter()
    records = {}
    for d in _gather(mine):  # every rank has written its file
        records.update(d)
    if _before_manifest_write is not None:
        _before_manifest_write(iteration)
    first = min(hosts)
    items = {name: _fold([records[r][name] for r in range(world)]) for name in mine[first]}
    for name, value in (folds or {}).items():
        if name in items:
            items[name]["fold"] = int(value)
    if train_meta:
        items["train_meta"] = _meta_digest(train_meta)
    _agreed(commit, retry_policy, counters, "manifest commit")
    nbytes = sum(t.numel() * t.element_size() for host in hosts.values()
                 for leaves in host.values() for t in leaves.values())
    telemetry.emit("checkpoint_save", iteration=iteration, path=ckpt_dir,
                   duration_ms=(time.perf_counter() - t0) * 1e3,
                   emergency=True if (train_meta and train_meta.get("emergency")) else None)
    if keep_latest_k:
        gc_checkpoints(ckpt_dir, keep_latest_k)
        _barrier()
    out = {"bytes": nbytes, "seconds": time.perf_counter() - t0, "copy_s": t1 - t0,
           "digest_s": t2 - t1, "write_s": t3 - t2, "items": mine[first]}
    if len(hosts) > 1:
        out["ranks"] = mine
    return out


def gc_checkpoints(ckpt_dir: str, keep_latest_k: int, protect: Any = ()) -> List[int]:
    """Delete all but the newest `keep_latest_k` steps and their manifests
    (rank 0 only); returns the deleted iterations. Never deletes a step being
    restored, one in `protect`, or the newest intact step."""
    if keep_latest_k <= 0 or _world()[0] != 0:
        return []
    with _RESTORING_LOCK:
        keep = set(protect) | set(_RESTORING)
    intact = intact_iterations(ckpt_dir)
    if intact:
        keep.add(max(intact))
    steps = all_iterations(ckpt_dir)
    doomed = steps[:-keep_latest_k] if keep_latest_k < len(steps) else []
    deleted = []
    for step in doomed:
        if step in keep:
            continue
        try:
            os.remove(_manifest_path(ckpt_dir, step))
        except OSError:
            pass
        try:
            shutil.rmtree(_step_dir(ckpt_dir, step))
        except OSError as e:
            telemetry.runtime_log("checkpoint gc: could not delete step %d: %s" % (step, e))
            continue
        deleted.append(step)
    if deleted:
        telemetry.emit("checkpoint_gc", deleted=deleted, path=ckpt_dir)
    return deleted


# ---------------------------------------------------------------------- load
def _diag(code: str, message: str, cls=D.DiagnosticError):
    return cls([D.make(code, message)])


def check_strategy(manifest: Dict[str, Any], hp: Optional[HybridParallelConfig],
                   model_cfg: Any = None) -> None:
    """Refuse a checkpoint this run cannot restore in place: another world
    size or strategy (GLS206), another model (GLS201)."""
    world = int(manifest.get("world_size", 1))
    if hp is not None and not _same_strategy(manifest, hp):
        raise _diag("GLS206", "the checkpoint was written at world size %d under another "
                    "strategy than this run's (world size %d): resume with the strategy of "
                    "the checkpoint's provenance, or restore across strategies with "
                    "--elastic resume|search" % (world, hp.world_size))
    prov = manifest.get("provenance")
    if model_cfg is not None and prov and prov.get("model_digest"):
        from galvatron_tpu_torch.runtime.provenance import model_config_digest

        if prov["model_digest"] != model_config_digest(model_cfg):
            raise _diag("GLS201", "the checkpoint's model-config digest differs from this "
                        "run's model: it was written for another architecture")


def _same_strategy(manifest: Dict[str, Any], hp: HybridParallelConfig) -> bool:
    """Whether a step was written at `hp`'s world size under `hp` (a step
    without provenance: by its world size alone)."""
    saved = (manifest.get("provenance") or {}).get("strategy")
    return (int(manifest.get("world_size", 1)) == hp.world_size
            and (saved is None or saved == hp.to_json_dict()))


def _copy_into(target: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor], what: str):
    if set(target) != set(saved):
        missing, extra = sorted(set(target) - set(saved)), sorted(set(saved) - set(target))
        raise _diag("GLS202", "%s: the checkpoint's leaves differ from the target's "
                    "(missing %s, unexpected %s)" % (what, missing[:3], extra[:3]))
    with torch.no_grad():
        for n, t in target.items():
            s = saved[n]
            if tuple(s.shape) != tuple(t.shape) or s.dtype != t.dtype:
                raise _diag("GLS202", "%s: leaf %s is %s %s in the checkpoint, %s %s here"
                            % (what, n, s.dtype, tuple(s.shape), t.dtype, tuple(t.shape)))
            t.copy_(s)


def _verify(manifest: Dict[str, Any], rank: int,
            loaded: Dict[str, Any]) -> Optional[Tuple[str, str]]:
    """None when this rank's restored items match their manifest records,
    else (GLS code, reason)."""
    for name, got in loaded.items():
        ranks = manifest.get("items", {}).get(name, {}).get("ranks")
        if not isinstance(ranks, list) or len(ranks) <= rank:
            return "GLS212", "malformed manifest: no record of item %r for rank %d" % (name, rank)
        want = ranks[rank]
        if want.get("num_leaves") != got["num_leaves"]:
            return "GLS214", "item %r: leaf count %s != manifest %s" % (
                name, got["num_leaves"], want.get("num_leaves"))
        if want.get("spec_digest") != got["spec_digest"]:
            return "GLS214", "item %r: dtypes or shapes differ from the manifest" % name
        if want.get("digest") != got["digest"]:
            return "GLS214", "item %r: content digest mismatch" % name
    return None


def _read_rank(ckpt_dir: str, step: int, rank: int) -> Dict[str, Any]:
    # mapped, not read: only the leaves a caller touches are paged in
    return torch.load(_rank_file(ckpt_dir, step, rank), map_location="cpu", weights_only=True,
                      mmap=True)


def _saved_strategy(manifest: Dict[str, Any], ckpt_dir: str,
                    iteration: int) -> HybridParallelConfig:
    """The strategy a committed step was written under (its provenance:
    GLS204 without one)."""
    prov = manifest.get("provenance")
    if not prov or not prov.get("strategy"):
        raise _diag("GLS204", "checkpoint %s step %d carries no provenance: its strategy, and "
                    "so where each rank's shards belong, is unknown" % (ckpt_dir, iteration))
    world = int(manifest.get("world_size", prov.get("world_size", 1)))
    return HybridParallelConfig.from_json(dict(prov["strategy"]), world_size=world)


# ------------------------------------------------------ cross-strategy restore
Region = Tuple[Tuple[int, int], ...]


def _region(shape, spec, mesh) -> Region:
    """The [start, stop) per dim of the full tensor that `mesh`'s rank holds
    under `spec` (equal contiguous chunks, chunk i on shard index i)."""
    out = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else ()
        k = mesh.size(ax) if ax else 1
        i = mesh.shard_index(ax) if ax else 0
        out.append((i * (n // k), (i + 1) * (n // k)))
    return tuple(out)


def _overlap(a: Region, b: Region) -> Optional[Region]:
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return None if any(lo >= hi for lo, hi in out) else out


def _within(region: Region, outer: Region) -> Tuple[slice, ...]:
    """`region`'s index in a tensor that holds `outer`."""
    return tuple(slice(lo - o0, hi - o0) for (lo, hi), (o0, _) in zip(region, outer))


def _saved_specs(cfg, hp: HybridParallelConfig) -> Dict[str, Dict[str, Any]]:
    """Per item (``params``, ``mu``, ``nu``) and parameter, its placement
    under `hp`: the parameter's layout, and for the Adam moments that layout
    dp-sharded on `moment_dim` wherever ZeRO-2 applies
    (``HybridParallelModel.grad_accum_specs``)."""
    from galvatron_tpu_torch.parallel.mesh import RankMesh
    from galvatron_tpu_torch.runtime.model_api import model_def
    from galvatron_tpu_torch.runtime.optimizer import moment_dim, moment_spec

    arch = model_def(cfg, hp)
    layouts = arch.param_layouts()
    mesh = RankMesh(hp, 0)
    moments = {}
    for n, p in arch.tree("meta").named_parameters():
        pl = layouts[n]
        d = moment_dim(pl.spec, p.shape, mesh.size(pl.dp), pl.zero_opt, pl.z3_dim is not None)
        moments[n] = moment_spec(pl.spec, p.dim(), d, pl.dp)
    return {"params": {n: pl.spec for n, pl in layouts.items()}, "mu": moments, "nu": moments}


def _rank_leaves(f: Dict[str, Any]):
    """(item, parameter name, (file item, key)) of each tensor leaf of a
    rank file but the Adam count; item is ``params``, ``mu`` or ``nu``."""
    for n in f["params"]:
        yield "params", n, ("params", n)
    for k in f.get("opt_state", {}):
        if k != "count":
            item, n = k.split("/", 1)
            yield item, n, ("opt_state", k)


class SavedShards:
    """The shards of a checkpoint step in every saved rank's (memory-mapped)
    file, located in the full tensors by the saved strategy: for each
    (item, name) the distinct regions the saved ranks hold (replicas once),
    so a reader copies each byte it needs from one file and pages in
    nothing else."""

    def __init__(self, files: Dict[int, Dict[str, Any]], saved_hp: HybridParallelConfig, cfg):
        from galvatron_tpu_torch.parallel.mesh import RankMesh
        from galvatron_tpu_torch.runtime.model_api import model_def

        self.shapes = {n: tuple(p.shape) for n, p in model_def(cfg, saved_hp).tree("meta")
                       .named_parameters()}
        specs = _saved_specs(cfg, saved_hp)
        self.files = files
        self.sources: Dict[Tuple[str, str], Dict[Region, Tuple[int, Tuple[str, str]]]] = {}
        self.counts = set()
        for r, f in files.items():
            mesh = RankMesh(saved_hp, r)
            if "count" in f.get("opt_state", {}):
                self.counts.add(int(f["opt_state"]["count"]))
            for item, n, key in _rank_leaves(f):
                reg = _region(self.shapes[n], specs[item][n], mesh)
                self.sources.setdefault((item, n), {}).setdefault(reg, (r, key))

    def fill_target(self, target: Any, params: Dict[int, nn.Module],
                    opt_state: Optional[Dict[int, AdamState]], what: str) -> None:
        """Fill every hosted stage's live shards of `target`'s params and,
        with `opt_state`, of both moments and the count, one leaf at a
        time (GLS202 when the step holds no optimizer state)."""
        if opt_state is not None and not self.counts:
            raise _diag("GLS202", "%s holds no optimizer state" % what)
        moment_specs = target.grad_accum_specs()
        for s, module in params.items():
            mesh = target.stage_meshes[s]
            for n, p in module.named_parameters():
                self.fill("params", n, p.data, _region(self.shapes[n],
                                                       target.param_layouts[n].spec, mesh))
                if opt_state is not None:
                    reg = _region(self.shapes[n], moment_specs[n], mesh)
                    self.fill("mu", n, opt_state[s].mu[n], reg)
                    self.fill("nu", n, opt_state[s].nu[n], reg)
            if opt_state is not None:
                opt_state[s].count = min(self.counts)

    def fill(self, item: str, name: str, out: torch.Tensor, region: Region) -> None:
        """Copy the saved bytes of `region` of the full tensor into `out`
        (which holds that region); every element must be covered (GLS202
        otherwise)."""
        if (item, name) not in self.sources:
            raise _diag("GLS202", "%s/%s: the checkpoint holds no such leaf" % (item, name))
        covered = 0
        with torch.no_grad():
            for reg, (r, (rec, key)) in self.sources[(item, name)].items():
                ov = _overlap(region, reg)
                if ov is None:
                    continue
                src = self.files[r][rec][key][_within(ov, reg)]
                if src.dtype != out.dtype:
                    raise _diag("GLS202", "%s/%s is %s in the checkpoint, %s here"
                                % (item, name, src.dtype, out.dtype))
                out[_within(ov, region)].copy_(src)
                covered += src.numel()
        if covered != out.numel():
            raise _diag("GLS202", "%s/%s: the saved shards cover %d of the %d elements of "
                        "the target's shard" % (item, name, covered, out.numel()))


def _continuity(manifest: Dict[str, Any], files: Dict[int, Dict[str, Any]],
                saved_hp: HybridParallelConfig, target: Any, params: Dict[int, nn.Module],
                opt_state: Optional[Dict[int, AdamState]]) -> Tuple[List[str], int]:
    """The reference's GLS016 digest-continuity check, held against the
    manifest: each live leaf, gathered under its canonical name one leaf at
    a time, is cut again under the saved strategy for every saved rank
    that holds it (``parallel.spec.shard_tensor``, not the regions the
    restore copied by), and every saved rank's records must come out as
    its manifest's. Each leaf is hashed by one process (replicas once), on
    the host, while the next is gathered. Returns the records that differ
    and the number of leaves this process hashed."""
    from galvatron_tpu_torch.parallel import spec as S
    from galvatron_tpu_torch.parallel.mesh import RankMesh

    rank, world = _world()
    specs = _saved_specs(target.cfg, saved_hp)
    live = {"params": {s: dict(m.named_parameters()) for s, m in params.items()}}
    live_specs = {"params": {n: pl.spec for n, pl in target.param_layouts.items()}}
    if opt_state is not None:
        live.update(mu={s: st.mu for s, st in opt_state.items()},
                    nu={s: st.nu for s, st in opt_state.items()})
        live_specs["mu"] = live_specs["nu"] = target.grad_accum_specs()
    meshes = {r: RankMesh(saved_hp, r) for r in files}
    holders: Dict[Tuple[str, str], list] = {}
    for r, f in files.items():
        for item, n, key in _rank_leaves(f):
            if item in live:
                holders.setdefault((item, n), []).append((r, key))

    def shas(item, n, full):
        out, seen = [], {}
        for r, (rec, key) in holders[(item, n)]:
            shard = S.shard_tensor(full, specs[item][n], meshes[r])
            at = (shard.storage_offset(), tuple(shard.shape), shard.stride())
            if at not in seen:
                seen[at] = _leaf_sha(shard.contiguous())
            out.append((r, rec, key, str(shard.dtype), tuple(shard.shape), seen[at]))
        return out

    mine, pending = [], []
    workers = max(1, min(8, os.cpu_count() or 1))
    # hashlib releases the GIL; at most `workers` + 1 leaves wait on the host
    with ThreadPoolExecutor(workers) as ex:
        for i, (item, n) in enumerate(sorted(holders)):
            full = target.gather_leaf(live[item], n, live_specs[item][n])  # collective
            if i % world == rank:
                pending.append(ex.submit(shas, item, n, full))
            del full
            while len(pending) > workers:
                mine += pending.pop(0).result()
        for fut in pending:
            mine += fut.result()
    checked = len(mine)
    if opt_state is not None and rank == 0:
        count = torch.tensor(int(next(iter(opt_state.values())).count), dtype=torch.int64)
        mine += [(r, "opt_state", "count", str(count.dtype), (), _leaf_sha(count))
                 for r, f in files.items() if "count" in f.get("opt_state", {})]
    records: Dict[Tuple[int, str], Dict[str, Tuple[str, tuple, str]]] = {}
    for part in _gather(mine):
        for r, rec, key, dtype, shape, sha in part:
            records.setdefault((r, rec), {})[key] = (dtype, shape, sha)
    bad = []
    for (r, rec), leaves in sorted(records.items()):
        want = manifest["items"][rec]["ranks"][r]
        got = _fold_leaves(leaves)
        if any(got[k] != want.get(k) for k in ("digest", "spec_digest", "num_leaves")):
            bad.append("rank %d %s" % (r, rec))
    return bad, checked


def same_pipeline_layout(a: HybridParallelConfig, b: HybridParallelConfig) -> bool:
    """True when both strategies stage the layers alike (pp and division):
    then a family's own tree has the same parameters on every stage."""
    return a.pp == b.pp and (a.pp == 1 or list(a.pp_division) == list(b.pp_division))


def check_family_layout(cfg, saved_hp: HybridParallelConfig, hp: HybridParallelConfig) -> None:
    """GLS207: a family that builds its own tree (T5, Swin) is restored
    across strategies only under the pipeline layout it was saved with, as
    the reference's migration refuses them across layouts."""
    from galvatron_tpu_torch.models.base import GenericDef
    from galvatron_tpu_torch.runtime.model_api import model_def

    if not isinstance(model_def(cfg, hp), GenericDef) and not same_pipeline_layout(saved_hp, hp):
        raise _diag("GLS207", "restore across pipeline layouts (pp %d %s -> pp %d %s) is only "
                    "supported for the generic transformer tree; this family builds its own "
                    "params" % (saved_hp.pp, list(saved_hp.pp_division), hp.pp,
                                list(hp.pp_division)))


def _restore_across(ckpt_dir: str, step: int, manifest: Dict[str, Any],
                    saved_hp: HybridParallelConfig, target: Any, params: Dict[int, nn.Module],
                    opt_state: Optional[Dict[int, AdamState]], verify: bool):
    """Restore `step`, written under `saved_hp`, into the live shards of
    `target` (every hosted stage of this process): (None, restore stats),
    or ((code, reason), None) when the saved bytes fail their manifest.

    1. Integrity on the bytes as saved: saved rank r's file is verified
       against its manifest record by process r mod world (all agree).
    2. Each target shard of a parameter and of both moments (ZeRO-2 moment
       shards included) is filled from the saved ranks' shards that overlap
       it; the count from the files. A pipeline division change is
       renaming: stage files key layers by their global index, and the last
       stage's copy of a tied table comes from the first stage's file.
    3. Continuity (`_continuity`, GLS016): the restored leaves, cut again
       under the saved strategy, reproduce the manifest's records."""
    rank, world = _world()
    t0 = time.perf_counter()
    reason = None
    if verify:
        for r in range(rank, saved_hp.world_size, world):
            loaded = _read_rank(ckpt_dir, step, r)
            reason = _verify(manifest, r, {k: tree_digests(v) for k, v in loaded.items()})
            if reason is not None:
                break
    reason = next((x for x in _gather(reason) if x is not None), None)
    if reason is not None:
        return reason, None
    verify_s = time.perf_counter() - t0
    files = {r: _read_rank(ckpt_dir, step, r) for r in range(saved_hp.world_size)}
    saved = SavedShards(files, saved_hp, target.cfg)
    t1 = time.perf_counter()
    saved.fill_target(target, params, opt_state, "checkpoint %s step %d" % (ckpt_dir, step))
    t2 = time.perf_counter()
    dev = next(next(iter(params.values())).parameters()).device
    if dev.type == "cuda":  # what the check takes beyond the live state
        torch.cuda.synchronize(dev)
        live_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    bad, checked = _continuity(manifest, files, saved_hp, target, params, opt_state)
    extra_gb = None
    if dev.type == "cuda":
        extra_gb = (torch.cuda.max_memory_allocated(dev) - live_bytes) / 1e9
    if len(saved.counts) > 1:
        bad.append("count: the saved ranks hold counts %s" % sorted(saved.counts))
    if bad:
        raise _diag("GLS016", "cross-strategy restore of %s step %d does not reproduce the "
                    "manifest's records of %s" % (ckpt_dir, step, bad[:4]))
    nbytes = sum(t.numel() * t.element_size() for m in params.values() for t in m.parameters())
    if opt_state is not None:
        nbytes += sum(2 * t.numel() * t.element_size() for st in opt_state.values()
                      for t in st.mu.values())
    return None, {"bytes": nbytes, "verify_s": verify_s, "move_s": t2 - t1,
                  "continuity_s": time.perf_counter() - t2, "digest_s": verify_s,
                  "cross_strategy": True, "leaves_checked": checked,
                  "device_extra_gb": extra_gb,
                  "saved_world_size": saved_hp.world_size,
                  "saved_strategy": saved_hp.to_json_dict()}


def load_checkpoint(
    ckpt_dir: str,
    iteration: Optional[int] = None,
    *,
    params_target: Any,
    opt_state_target: Optional[AdamState] = None,
    hp: Optional[HybridParallelConfig] = None,
    model_cfg: Any = None,
    strict_strategy: bool = True,
    verify_integrity: bool = True,
    retry_policy: Any = None,
    counters: Any = None,
    target: Any = None,
    allow_cross: bool = False,
    sdc_check: bool = False,
):
    """Restore (params, opt_state, train_meta) of this rank in place into
    `params_target` (a module or name -> tensor) and `opt_state_target`.
    Collective under a process group of more than one rank.

    With `target` (the live ``HybridParallelModel``, whose strategy is then
    `hp`), `params_target` and `opt_state_target` are its per-stage params
    and Adam states. A step of the target's strategy is copied into this
    rank's checkpoint view (``checkpoint_view``; the tied table's
    last-stage copy is refilled by ``restore_tied``). A step of another
    strategy or world size, and any step into a process that hosts every
    stage of a pipeline (it has no one rank's file), is restored across
    strategies (`_restore_across`) — the former only with `allow_cross`
    (``--elastic``), else it refuses with GLS206.

    Each candidate step — the named `iteration`, else every step newest
    first — must have a committed manifest whose records match this rank's
    restored bytes (every rank agreeing); a torn step is skipped (reported
    in ``meta["torn_iterations"]``) unless it was named, which raises
    `CheckpointIntegrityError` (GLS210 / GLS214). `retry_policy` and
    `counters` (``runtime.resilience``) put backoff around the manifest
    reads and the file reads. With `strict_strategy` a checkpoint of
    another strategy or world refuses (GLS206) unless `allow_cross`;
    `model_cfg` adds the model digest check (GLS201). Without
    `verify_integrity` the byte digests are not checked; the committed
    manifest is still required. Returns (params_target, opt_state or None,
    meta) with ``meta["restore"]`` = {"bytes", "seconds", "digest_s", ...}.
    With `sdc_check`, a restore across strategies is also held to the
    layout-invariant folds the manifest records (``runtime/sdc.py``,
    GLS016), as the reference's sentinel holds it."""
    from galvatron_tpu_torch.runtime import resilience as rsl

    t0 = time.perf_counter()
    rank, _ = _world()

    def retrying(fn, what):
        return rsl.with_retry(fn, retry_policy, counters, description=what) \
            if retry_policy is not None else fn()

    def manifest_of(step):
        """(manifest, None) or (None, (GLS code, reason))."""
        try:
            m = retrying(lambda: _read_manifest_raising(ckpt_dir, step), "manifest read")
        except ValueError as e:
            return None, ("GLS212", "malformed manifest: %s" % e)
        except OSError as e:
            return None, ("GLS210", "unreadable manifest: %s" % e)
        if m is None:
            return None, ("GLS210", "no committed manifest (torn save)")
        return m, None

    explicit = iteration is not None
    candidates = _from_rank0([iteration] if explicit else sorted(all_iterations(ckpt_dir),
                                                                   reverse=True))
    if not candidates:
        raise FileNotFoundError("no checkpoint found under %s" % ckpt_dir)
    stages = None
    if target is not None:
        hp, stages = target.hp, (params_target, opt_state_target)
        params_target = opt_state_target = None  # a hosted pipeline has no one rank view
        if len(stages[0]) == 1:
            params_target, opt_state_target = target.checkpoint_view(*stages)
    torn: Dict[int, str] = {}
    out = None
    want_opt = _opt_leaves(opt_state_target) if opt_state_target is not None else None
    for step in candidates:
        manifest, reason = manifest_of(step)
        across = False
        if manifest is not None:
            if strict_strategy:
                check_strategy(manifest, None if allow_cross else hp, model_cfg)
            across = stages is not None and (params_target is None
                                             or not _same_strategy(manifest, hp))
            rec = manifest.get("items", {}).get("opt_state")
            if (not across and want_opt is not None and rec is not None
                    and len(rec.get("ranks", ())) > rank):
                mine = rec["ranks"][rank]["num_leaves"]
                if mine != len(want_opt):
                    raise _diag("GLS202", "saved opt_state has %s leaves on rank %d but the "
                                "optimizer here expects %d: resume with the optimizer the "
                                "checkpoint was written with" % (mine, rank, len(want_opt)))
        loaded, stats, digests, digest_s = None, None, {}, 0.0
        if reason is None:
            with _RESTORING_LOCK:
                _RESTORING.add(step)
            try:
                if across:
                    saved_hp = _saved_strategy(manifest, ckpt_dir, step)
                    check_family_layout(target.cfg, saved_hp, target.hp)
                    # collective: its verdict is every rank's, and an error
                    # raises (a rank that went on would wait for the others)
                    reason, stats = _restore_across(ckpt_dir, step, manifest, saved_hp,
                                                    target, *stages, verify_integrity)
                else:
                    loaded = retrying(lambda s=step: _read_rank(ckpt_dir, s, rank),
                                      "checkpoint read")
            except Exception as e:  # noqa: BLE001 — a torn or unreadable step
                if across:
                    raise
                reason = "GLS214", "restore failed: %s: %s" % (type(e).__name__, e)
            finally:
                with _RESTORING_LOCK:
                    _RESTORING.discard(step)
        if reason is None and loaded is not None and verify_integrity:
            t_d = time.perf_counter()
            digests = {name: tree_digests(leaves) for name, leaves in loaded.items()}
            digest_s = time.perf_counter() - t_d
            reason = _verify(manifest, rank, digests)
        verdicts = _gather(reason)
        reason = next((r for r in verdicts if r is not None), None)
        if reason is not None:
            code, why = reason
            if explicit:
                raise _diag(code, "checkpoint %s step %d failed integrity verification: %s"
                            % (ckpt_dir, step, why), CheckpointIntegrityError)
            torn[step] = why
            continue
        out = step, loaded, stats, digests, digest_s
        chosen = manifest
        break
    if out is None:
        raise FileNotFoundError("no intact checkpoint under %s (torn steps skipped: %s)"
                                % (ckpt_dir, dict(sorted(torn.items()))))
    step, loaded, stats, digests, digest_s = out
    opt_state = None
    if stats is not None:
        params_target, opt_state = stages
        if sdc_check:
            _fold_continuity(chosen, target, params_target, opt_state, step)
    else:
        _copy_into(_param_leaves(params_target), loaded["params"], "params")
        if opt_state_target is not None and "opt_state" in loaded:
            saved = loaded["opt_state"]
            _copy_into({n: t for n, t in want_opt.items() if n != "count"},
                       {n: t for n, t in saved.items() if n != "count"}, "opt_state")
            opt_state_target.count = int(saved["count"])
            opt_state = opt_state_target
        nbytes = sum(t.numel() * t.element_size() for leaves in loaded.values()
                     for t in leaves.values())
        stats = {"bytes": nbytes, "digest_s": digest_s, "digests": digests}
        if stages is not None:
            if opt_state is not None:
                target.restore_tied(*stages, opt_state)
            params_target, opt_state = stages[0], stages[1] if opt_state is not None else None
    meta_path = os.path.join(_step_dir(ckpt_dir, step), "train_meta.json")
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta.setdefault("iteration", step)
    if torn:
        meta["torn_iterations"] = sorted(torn)
        telemetry.runtime_log("checkpoint: fell back to intact step %d; skipped torn steps %s"
                              % (step, sorted(torn)))
    meta["restore"] = dict(stats, seconds=time.perf_counter() - t0)
    _emit_restore(int(meta["iteration"]), ckpt_dir, meta["restore"], len(torn))
    return params_target, opt_state, meta


def _fold_continuity(manifest, target, params, opt_state, step) -> None:
    """GLS016 unless the restored state's layout-invariant folds equal the
    ones the manifest recorded at the save (items without one are not
    checked: a save made without folds)."""
    from galvatron_tpu_torch.runtime import sdc

    items = manifest.get("items", {})
    if items.get("params", {}).get("fold") is not None:
        sdc.assert_digest_continuity(items["params"]["fold"], sdc.state_fold(target, params),
                                     "load_checkpoint(cross, params)", step)
    if opt_state is not None and items.get("opt_state", {}).get("fold") is not None:
        sdc.assert_digest_continuity(items["opt_state"]["fold"],
                                     sdc.state_fold(target, params, opt_state),
                                     "load_checkpoint(cross, opt_state)", step)


def _emit_restore(iteration: int, ckpt_dir: str, stats: Dict[str, Any], torn: int):
    """The ``checkpoint_restore`` telemetry event of a restore's stats."""
    telemetry.emit("checkpoint_restore", iteration=iteration, path=ckpt_dir,
                   duration_ms=stats["seconds"] * 1e3, torn_skipped=torn or None,
                   cross_strategy=True if stats.get("cross_strategy") else None,
                   device_extra_gb=stats.get("device_extra_gb"))


def _full_state(ckpt_dir: str, iteration: Optional[int], cfg, moments: bool,
                strict_model: bool = True):
    """Every saved rank's file verified against the manifest, and its
    shards copied into the full tensors where the saved strategy puts them
    (``parallel.spec.shard_tensor``); each leaf must fill its place of
    `cfg`'s tree exactly (GLS202). Without `strict_model` a step whose
    model digest differs from `cfg`'s is read all the same (a warning)."""
    from galvatron_tpu_torch.parallel import spec as S
    from galvatron_tpu_torch.parallel.mesh import RankMesh
    from galvatron_tpu_torch.runtime.model_api import model_def

    if iteration is None:
        intact = intact_iterations(ckpt_dir)
        if not intact:
            raise FileNotFoundError("no intact checkpoint under %s" % ckpt_dir)
        iteration = intact[-1]
    manifest = read_manifest(ckpt_dir, iteration)
    if manifest is None:
        raise _diag("GLS210", "checkpoint %s step %d has no committed manifest (torn save)"
                    % (ckpt_dir, iteration), CheckpointIntegrityError)
    saved_hp = _saved_strategy(manifest, ckpt_dir, iteration)
    try:
        check_strategy(manifest, None, cfg)
    except D.DiagnosticError as e:
        if strict_model:
            raise
        telemetry.runtime_log("checkpoint %s step %d: %s; reading its leaves by name and "
                              "shape" % (ckpt_dir, iteration, e.diagnostics[0].message))
    specs = _saved_specs(cfg, saved_hp)
    items = ("params", "mu", "nu") if moments else ("params",)
    full = {item: {n: torch.empty(p.shape, dtype=cfg.param_dtype)
                   for n, p in model_def(cfg, saved_hp).tree("meta").named_parameters()}
            for item in items}
    counts, filled = set(), set()
    for r in range(saved_hp.world_size):
        loaded = _read_rank(ckpt_dir, iteration, r)
        kept = {k: loaded[k] for k in ("params", "opt_state") if k in loaded
                and (moments or k == "params")}
        bad = _verify(manifest, r, {k: tree_digests(v) for k, v in kept.items()})
        if bad is not None:
            raise _diag(bad[0], "checkpoint %s step %d, rank %d: %s"
                        % (ckpt_dir, iteration, r, bad[1]), CheckpointIntegrityError)
        mesh = RankMesh(saved_hp, r)
        for item, n, (rec, key) in _rank_leaves(kept):
            saved = kept[rec][key]
            if n not in full[item]:
                raise _diag("GLS202", "checkpoint %s step %d holds %s %r, which this model "
                            "has not" % (ckpt_dir, iteration, item, n))
            place = S.shard_tensor(full[item][n], specs[item][n], mesh)
            if tuple(place.shape) != tuple(saved.shape) or saved.dtype != place.dtype:
                raise _diag("GLS202", "checkpoint %s step %d: %s %r is %s %s there, %s %s here"
                            % (ckpt_dir, iteration, item, n, saved.dtype, tuple(saved.shape),
                               place.dtype, tuple(place.shape)))
            place.copy_(saved)
            filled.add((item, n))
        if "count" in kept.get("opt_state", {}):
            counts.add(int(kept["opt_state"]["count"]))
    missing = sorted(n for item in items for n in full[item] if (item, n) not in filled)
    if missing:
        raise _diag("GLS202", "checkpoint %s step %d lacks %s of this model"
                    % (ckpt_dir, iteration, missing[:3]))
    state = None
    if moments:
        if len(counts) != 1:
            raise _diag("GLS202", "checkpoint %s step %d: the saved ranks hold Adam counts %s"
                        % (ckpt_dir, iteration, sorted(counts)))
        state = AdamState(count=counts.pop(), mu=full["mu"], nu=full["nu"])
    meta_path = os.path.join(_step_dir(ckpt_dir, iteration), "train_meta.json")
    meta = {"iteration": iteration}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta.update(json.load(f))
    return full["params"], state, meta


def load_full_params(ckpt_dir: str, iteration: Optional[int], cfg, strict_model: bool = True
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The FULL parameters of a checkpoint of any world size and strategy,
    assembled in this process from every rank's file and verified against
    the manifest (the optimizer state is not read): name
    -> CPU tensor, and the train metadata. Needs the manifest's provenance
    (GLS204) for the saved strategy; `cfg` must be the checkpoint's model
    (GLS201), or with `strict_model` False have its leaves' names and
    shapes (GLS202): an HF conversion trained from (as the reference, which
    checks no model there) under a config that may differ from the
    converted one in what no leaf shows (its sequence length), and the HF
    export."""
    params, _, meta = _full_state(ckpt_dir, iteration, cfg, False, strict_model)
    return params, meta


def load_full_state(ckpt_dir: str, iteration: Optional[int],
                    cfg) -> Tuple[Dict[str, torch.Tensor], AdamState, Dict[str, Any]]:
    """`load_full_params` with the Adam state: the full parameters, an
    AdamState of the full moments (ZeRO-2 shards reassembled) and the
    count, and the train metadata."""
    return _full_state(ckpt_dir, iteration, cfg, moments=True)
