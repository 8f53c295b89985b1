"""The port's sharded checkpoints (``galvatron_tpu_torch/runtime/checkpoint.py``)
on the CPU: the cases of the reference's tests/cli/test_checkpoint.py and of
the manifest half of tests/runtime/test_resilience.py — round trip, latest
iteration, the integrity manifest, a torn save falling back to the newest
intact step, corrupted bytes caught by the digest, keep_latest_k, GC never
deleting the newest intact step or one being restored, stray directories,
retried manifest reads and the retry budget — plus the refusals this slice
adds (another strategy GLS206, another model GLS201, another optimizer
tree GLS202, a named torn step GLS210 / GLS214, no provenance GLS204) and
the full parameters `cli serve --load` assembles."""

import json
import os

import pytest
import torch

from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.runtime import checkpoint as ck
from galvatron_tpu_torch.runtime import resilience as rsl
from galvatron_tpu_torch.runtime.optimizer import AdamState
from galvatron_tpu_torch.runtime.provenance import build_provenance
from tests.runtime.fault_injection import flaky_calls


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g), "b": torch.randn(4, generator=g)}


def _zeros():
    return {"w": torch.zeros(8, 4), "b": torch.zeros(4)}


def _opt(tree, count=3):
    return AdamState(count=count, mu={n: t * 0.5 for n, t in tree.items()},
                     nu={n: t * t for n, t in tree.items()})


def _save_steps(d, steps):
    for s in steps:
        ck.save_checkpoint(d, s, _tree(s), train_meta={"iteration": s})


def tear_checkpoint(ckpt_dir, iteration, mode="manifest"):
    """Delete the manifest ("manifest": a kill before the commit) or flip
    bytes in the middle of every rank file ("data": bit rot)."""
    if mode == "manifest":
        os.remove(ck._manifest_path(ckpt_dir, iteration))
        return
    step_dir = os.path.join(ckpt_dir, str(iteration))
    for name in os.listdir(step_dir):
        if name.endswith(".pt"):
            path = os.path.join(step_dir, name)
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.seek(size // 2)
                chunk = f.read(16)
                f.seek(size // 2)
                f.write(bytes(b ^ 0xFF for b in chunk))


def test_roundtrip_params_and_adam_state(tmp_path):
    d = str(tmp_path / "c")
    tree = _tree(1)
    info = ck.save_checkpoint(d, 3, tree, _opt(tree), train_meta={"iteration": 3})
    assert info["bytes"] == 3 * 36 * 4 + 8
    target, state = _zeros(), _opt(_zeros(), count=0)
    out, opt, meta = ck.load_checkpoint(d, params_target=target, opt_state_target=state)
    assert out is target and opt is state and meta["iteration"] == 3
    for n in tree:
        assert torch.equal(target[n], tree[n])
        assert torch.equal(state.mu[n], tree[n] * 0.5) and torch.equal(state.nu[n], tree[n] ** 2)
    assert state.count == 3
    assert meta["restore"]["digests"]["params"] == info["items"]["params"]
    assert ck.state_digests(target, state) == info["items"]


def test_layout_files_and_manifest(tmp_path):
    d = str(tmp_path / "c")
    hp = HybridParallelConfig.uniform(1, 2, global_bsz=4)
    ck.save_checkpoint(d, 2, _tree(), hp=hp, train_meta={"iteration": 2},
                       provenance={"format": 1, "strategy": hp.to_json_dict()})
    assert sorted(os.listdir(d)) == ["2", "hybrid_parallel_config.json", "manifests", "meta.json"]
    assert sorted(os.listdir(os.path.join(d, "2"))) == ["rank0.pt", "train_meta.json"]
    m = ck.read_manifest(d, 2)
    assert m["iteration"] == 2 and m["world_size"] == 1
    assert set(m["items"]) == {"params", "train_meta"}
    assert m["items"]["params"]["num_leaves"] == 2 and len(m["items"]["params"]["ranks"]) == 1
    assert ck.read_provenance(d) == (2, m["provenance"])
    assert not any(n.startswith("2.json.tmp") for n in os.listdir(os.path.join(d, "manifests")))


def test_latest_iteration(tmp_path):
    assert ck.latest_iteration(str(tmp_path / "none")) is None
    d = str(tmp_path / "c")
    _save_steps(d, [1, 5])
    assert ck.latest_iteration(d) == 5


def test_resave_replaces_the_step(tmp_path):
    d = str(tmp_path / "c")
    ck.save_checkpoint(d, 4, _tree(1))
    ck.save_checkpoint(d, 4, _tree(2))
    target = _zeros()
    ck.load_checkpoint(d, params_target=target)
    assert torch.equal(target["w"], _tree(2)["w"])


def test_manifest_written_and_verified(tmp_path):
    d = str(tmp_path / "c")
    ck.save_checkpoint(d, 2, _tree(), train_meta={"iteration": 2})
    assert ck.read_manifest(d, 2) is not None and ck.intact_iterations(d) == [2]
    target = _zeros()
    _, _, meta = ck.load_checkpoint(d, params_target=target)
    assert meta["iteration"] == 2 and torch.equal(target["w"], _tree()["w"])


def test_torn_checkpoint_falls_back_to_latest_intact(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [2, 4])
    tear_checkpoint(d, 4, mode="manifest")
    assert ck.intact_iterations(d) == [2]
    target = _zeros()
    _, _, meta = ck.load_checkpoint(d, params_target=target)
    assert meta["iteration"] == 2 and meta["torn_iterations"] == [4]
    assert torch.equal(target["w"], _tree(2)["w"])
    # a named torn step raises, it does not fall back
    with pytest.raises(RuntimeError) as e:
        ck.load_checkpoint(d, 4, params_target=_zeros())
    assert e.value.diagnostics[0].code == "GLS210"


def test_corrupted_payload_caught_by_digest(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [1, 3])
    tear_checkpoint(d, 3, mode="data")
    target = _zeros()
    _, _, meta = ck.load_checkpoint(d, params_target=target)
    assert meta["iteration"] == 1 and torch.equal(target["w"], _tree(1)["w"])
    with pytest.raises(RuntimeError) as e:
        ck.load_checkpoint(d, 3, params_target=_zeros())
    assert e.value.diagnostics[0].code == "GLS214"


def test_malformed_manifest_is_torn_and_named_gls212(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [1, 3])
    with open(ck._manifest_path(d, 3), "w") as f:
        f.write('{"items": {"params": {"dig')
    _, _, meta = ck.load_checkpoint(d, params_target=_zeros())
    assert meta["iteration"] == 1 and meta["torn_iterations"] == [3]
    with pytest.raises(RuntimeError) as e:
        ck.load_checkpoint(d, 3, params_target=_zeros())
    assert e.value.diagnostics[0].code == "GLS212"
    with open(ck._manifest_path(d, 3), "w") as f:
        json.dump({"format": 1, "iteration": 3, "items": {}}, f)
    with pytest.raises(RuntimeError) as e:
        ck.load_checkpoint(d, 3, params_target=_zeros())
    assert e.value.diagnostics[0].code == "GLS212"


def test_first_save_torn_before_its_commit_is_not_intact(tmp_path, monkeypatch):
    """A missing manifest always means torn, the first save's too: the
    manifests directory exists before any rank writes."""
    d = str(tmp_path / "c")

    def killed(iteration):
        raise KeyboardInterrupt("killed before the commit")

    monkeypatch.setattr(ck, "_before_manifest_write", killed)
    with pytest.raises(KeyboardInterrupt):
        ck.save_checkpoint(d, 5, _tree(5), train_meta={"iteration": 5})
    assert os.path.isdir(os.path.join(d, ck.MANIFEST_DIRNAME))
    assert ck.all_iterations(d) == [5] and ck.intact_iterations(d) == []
    with pytest.raises(FileNotFoundError, match="no intact checkpoint"):
        ck.load_checkpoint(d, params_target=_zeros())
    with pytest.raises(RuntimeError) as e:
        ck.load_checkpoint(d, 5, params_target=_zeros(), verify_integrity=False)
    assert e.value.diagnostics[0].code == "GLS210"


def test_save_retries_a_transient_rank_write(tmp_path):
    d = str(tmp_path / "c")
    counters = rsl.ResilienceCounters()
    with flaky_calls(ck, "_write_rank_file", failures=1):
        ck.save_checkpoint(d, 3, _tree(3), train_meta={"iteration": 3}, counters=counters,
                           retry_policy=rsl.RetryPolicy(retries=2, base_delay_s=0.0))
    assert counters.retries == 1 and counters.retries_succeeded == 1
    target = _zeros()
    _, _, meta = ck.load_checkpoint(d, params_target=target)
    assert meta["iteration"] == 3 and torch.equal(target["w"], _tree(3)["w"])


def test_save_write_failure_past_the_budget_raises_and_commits_nothing(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [1])
    counters = rsl.ResilienceCounters()
    with flaky_calls(ck, "_write_rank_file", failures=3):
        with pytest.raises(OSError):
            ck.save_checkpoint(d, 2, _tree(2), counters=counters,
                               retry_policy=rsl.RetryPolicy(retries=1, base_delay_s=0.0))
    assert counters.retries == 1 and counters.retries_exhausted == 1
    assert ck.intact_iterations(d) == [1]


def test_gc_keeps_latest_k(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [1, 2, 3])
    ck.save_checkpoint(d, 4, _tree(4), keep_latest_k=2)
    assert ck.intact_iterations(d) == [3, 4] and ck.latest_iteration(d) == 4
    assert ck.read_manifest(d, 1) is None and ck.read_manifest(d, 3) is not None


def test_gc_never_deletes_newest_intact_step(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [1, 2, 3, 4])
    for s in (3, 4):
        os.remove(ck._manifest_path(d, s))
    assert 2 not in ck.gc_checkpoints(d, keep_latest_k=1)
    assert ck.intact_iterations(d) == [2]
    _, _, meta = ck.load_checkpoint(d, params_target=_zeros())
    assert meta["iteration"] == 2


def test_gc_protects_step_being_restored(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [1, 2, 3])
    ck._RESTORING.add(1)
    try:
        deleted = ck.gc_checkpoints(d, keep_latest_k=1)
    finally:
        ck._RESTORING.discard(1)
    assert 1 not in deleted and 2 in deleted and 1 in ck.all_iterations(d)
    assert ck.gc_checkpoints(d, keep_latest_k=1, protect={1}) == []


def test_gc_tolerates_stray_directories(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [1, 2])
    os.makedirs(os.path.join(d, "not_a_step"))
    os.makedirs(os.path.join(d, "tmp.save-123"))
    assert ck.gc_checkpoints(d, keep_latest_k=1) == [1]
    _, _, meta = ck.load_checkpoint(d, params_target=_zeros())
    assert meta["iteration"] == 2


def test_restore_retries_transient_manifest_io(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [2])
    counters = rsl.ResilienceCounters()
    policy = rsl.RetryPolicy(retries=3, base_delay_s=0.0)
    with flaky_calls(ck, "_read_manifest_raising", failures=2):
        _, _, meta = ck.load_checkpoint(d, params_target=_zeros(), retry_policy=policy,
                                        counters=counters)
    assert meta["iteration"] == 2 and counters.retries == 2 and counters.retries_succeeded == 1


def test_restore_retry_budget_exhaustion_marks_torn(tmp_path, monkeypatch):
    d = str(tmp_path / "c")
    _save_steps(d, [2, 4])
    counters = rsl.ResilienceCounters()
    orig = ck._read_manifest_raising

    def flaky_step4(ckpt_dir, iteration):
        if iteration == 4:
            raise OSError("injected permanent failure")
        return orig(ckpt_dir, iteration)

    monkeypatch.setattr(ck, "_read_manifest_raising", flaky_step4)
    _, _, meta = ck.load_checkpoint(d, params_target=_zeros(),
                                    retry_policy=rsl.RetryPolicy(retries=1, base_delay_s=0.0),
                                    counters=counters)
    assert meta["iteration"] == 2 and meta["torn_iterations"] == [4]
    assert counters.retries == 1 and counters.retries_exhausted == 1


def test_transient_file_read_is_retried(tmp_path):
    d = str(tmp_path / "c")
    _save_steps(d, [2])
    counters = rsl.ResilienceCounters()
    with flaky_calls(ck, "_read_rank", failures=1):
        _, _, meta = ck.load_checkpoint(d, params_target=_zeros(), counters=counters,
                                        retry_policy=rsl.RetryPolicy(retries=2, base_delay_s=0))
    assert meta["iteration"] == 2 and counters.retries == 1


# ------------------------------------------------------------------ refusals
def _model_cfg(**kw):
    from galvatron_tpu_torch.models.base import TransformerConfig

    return TransformerConfig(**dict(dict(hidden_size=16, num_heads=2, num_layers=2,
                                         vocab_size=32, max_seq_len=16), **kw))


def test_strategy_guard_refuses_another_strategy_or_world(tmp_path):
    d = str(tmp_path / "c")
    cfg = _model_cfg()
    hp1 = HybridParallelConfig.uniform(1, 2, global_bsz=4)
    ck.save_checkpoint(d, 1, _tree(), hp=hp1, provenance=build_provenance(hp1, cfg))
    hp2 = HybridParallelConfig.uniform(1, 2, global_bsz=4, checkpoint=1)
    with pytest.raises(DiagnosticError) as e:
        ck.load_checkpoint(d, params_target=_zeros(), hp=hp2)
    assert e.value.diagnostics[0].code == "GLS206"
    _, _, meta = ck.load_checkpoint(d, params_target=_zeros(), hp=hp2, strict_strategy=False)
    assert meta["iteration"] == 1
    _, _, meta = ck.load_checkpoint(d, params_target=_zeros(), hp=hp1, model_cfg=cfg)
    assert meta["iteration"] == 1
    with pytest.raises(DiagnosticError) as e:
        ck.load_checkpoint(d, params_target=_zeros(), hp=hp1, model_cfg=_model_cfg(num_heads=4))
    assert e.value.diagnostics[0].code == "GLS201"


def test_optimizer_tree_mismatch_is_refused(tmp_path):
    d = str(tmp_path / "c")
    tree = _tree()
    ck.save_checkpoint(d, 1, tree, _opt(tree))
    small = AdamState(count=0, mu={"w": torch.zeros(8, 4)}, nu={"w": torch.zeros(8, 4)})
    with pytest.raises(DiagnosticError) as e:
        ck.load_checkpoint(d, params_target=_zeros(), opt_state_target=small)
    assert e.value.diagnostics[0].code == "GLS202"
    with pytest.raises(DiagnosticError) as e:
        ck.load_checkpoint(d, params_target={"w": torch.zeros(4, 8), "b": torch.zeros(4)})
    assert e.value.diagnostics[0].code == "GLS202"


def test_full_params_need_provenance_and_match_the_model(tmp_path):
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    cfg = _model_cfg()
    hp = HybridParallelConfig.uniform(1, 2, global_bsz=4)
    model = construct_hybrid_parallel_model(cfg, hp, "cpu")
    params = model.init_params(3)[0]
    d = str(tmp_path / "c")
    ck.save_checkpoint(d, 7, params, hp=hp, train_meta={"iteration": 7})
    with pytest.raises(DiagnosticError) as e:
        ck.load_full_params(d, None, cfg)
    assert e.value.diagnostics[0].code == "GLS204"
    ck.save_checkpoint(d, 8, params, hp=hp, train_meta={"iteration": 8},
                       provenance=build_provenance(hp, cfg))
    full, meta = ck.load_full_params(d, None, cfg)
    assert meta["iteration"] == 8
    for n, p in params.named_parameters():
        assert torch.equal(full[n], p.detach())
    with pytest.raises(DiagnosticError) as e:
        ck.load_full_params(d, 8, _model_cfg(num_layers=3))
    assert e.value.diagnostics[0].code == "GLS201"
    tear_checkpoint(d, 8, mode="data")
    with pytest.raises(RuntimeError):
        ck.load_full_params(d, 8, cfg)


def test_checkpoint_restore_telemetry(tmp_path):
    from galvatron_tpu_torch.obs import telemetry

    sink = telemetry.MemorySink()
    telemetry.install(sink)
    try:
        d = str(tmp_path / "c")
        _save_steps(d, [1, 2, 3])
        ck.save_checkpoint(d, 4, _tree(), keep_latest_k=2, train_meta={"iteration": 4})
        ck.load_checkpoint(d, params_target=_zeros())
    finally:
        telemetry.uninstall(sink)
    types = [e["type"] for e in sink.events]
    assert types.count("checkpoint_save") == 4 and "checkpoint_gc" in types
    assert "checkpoint_restore" in types
    json.dumps(sink.events)
