"""The port's silent-corruption sentinel (``galvatron_tpu_torch/runtime/sdc.py``,
the fold's plain version in ``ops/tree_fold.py``) and live migration's
refusals, against the JAX package on the CPU.

- The fold of a tree of fp32, bf16, fp16, int32, int64, float64, uint8 and
  bool leaves (odd lengths, an empty leaf) equals the reference's
  ``host_tree_fold`` and its jitted ``tree_fold_metrics`` bit for bit, and
  so does the fold of a model's parameters transplanted with
  ``tools.from_jax``; one flipped bit changes it.
- The layout-invariant fold of a model's state (`state_fold`: owned shards
  only) equals the fold of the whole tree, under a hosted pipeline too
  (the tied table counted once).
- `VoteLadder` and `vote_reason` against the reference's on the same
  sequences and strategies; digest continuity (GLS016); the manifest's
  fold and a cross-strategy restore held to it; the sentinel's lint
  (GLS103, GLS017) against the reference's lint.
- The digest is a side output: a digest run's trajectory is bitwise the
  one without it.
- Live migration refuses what the reference's tests/cli/test_migration.py
  refuses (GLS207: another global batch, a family with its own tree across
  pipeline layouts; GLS203: no strategy in the budget).

The world 2 / 4 cases (the fold under every layout, the vote's repair and
quarantine, migrations against save + resume) ride the workers of
tests/test_torch_parallel.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from galvatron_tpu.analysis import strategy_lint as JL
from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.models import base as JM
from galvatron_tpu.runtime import sdc as JS
from galvatron_tpu_torch.analysis import diagnostics as TD
from galvatron_tpu_torch.analysis import strategy_lint as TLint
from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
from galvatron_tpu_torch.config.strategy import LayerStrategy as TLS
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.ops import tree_fold as TF
from galvatron_tpu_torch.runtime import checkpoint as TC
from galvatron_tpu_torch.runtime import distributed as TDIST
from galvatron_tpu_torch.runtime import elastic as TE
from galvatron_tpu_torch.runtime import sdc as TS
from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model
from galvatron_tpu_torch.runtime.optimizer import OptimizerArgs, get_optimizer_and_scheduler
from galvatron_tpu_torch.tools.from_jax import params_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_rank_group():
    with TDIST.process_group("cpu"):
        yield


def _mixed_numpy():
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((33, 5)).astype(np.float32),
        "h": rng.standard_normal(7).astype(np.float16),
        "i": np.arange(11, dtype=np.int32) - 5,
        "j": (rng.integers(-2**62, 2**62, size=9, dtype=np.int64)),
        "d": rng.standard_normal(3).astype(np.float64),
        "u": rng.integers(0, 255, size=13, dtype=np.uint8),
        "b": np.array([True, False, True]),
        "empty": np.zeros((0,), np.float32),
    }


def test_plain_fold_equals_the_references_host_fold_on_every_dtype():
    tree = _mixed_numpy()
    want = JS.host_tree_fold(tree)
    torch_tree = {k: torch.from_numpy(v) for k, v in tree.items()}
    fold, sumsq = TF.tree_fold(torch_tree.values())
    assert int(fold) == want == TS.host_tree_fold(torch_tree) == TS.host_tree_fold(tree)
    ref_sumsq = sum(float(np.sum(np.square(v.astype(np.float32)))) for v in tree.values()
                    if v.dtype.kind == "f")
    assert float(sumsq) == pytest.approx(ref_sumsq, rel=1e-5)


def test_plain_fold_equals_the_references_jitted_fold_with_bf16():
    """bf16 elements are zero-extended one word each (never a pair per
    word), as the reference's ``_leaf_bits_u32``."""
    k = jax.random.PRNGKey(0)
    jtree = {"w": jax.random.normal(k, (33, 5), jnp.float32),
             "h": jax.random.normal(jax.random.fold_in(k, 1), (7,), jnp.bfloat16),
             "i": jnp.arange(11, dtype=jnp.int32), "b": jnp.array([True, False, True]),
             "empty": jnp.zeros((0,), jnp.float32)}
    jfold, jsumsq = jax.jit(JS.tree_fold_metrics)(jtree)
    host = jax.device_get(jtree)
    ttree = {"w": torch.from_numpy(np.array(host["w"])),
             "h": torch.from_numpy(np.asarray(host["h"]).view(np.uint16).astype(np.int32))
             .to(torch.int16).view(torch.bfloat16),
             "i": torch.from_numpy(np.array(host["i"])),
             "b": torch.from_numpy(np.array(host["b"])), "empty": torch.zeros(0)}
    fold, sumsq = TS.tree_fold_metrics(ttree)
    assert int(fold) == int(jfold) == JS.host_tree_fold(jtree)
    assert float(sumsq) == pytest.approx(float(jsumsq), rel=1e-5)


def test_fold_of_transplanted_params_equals_the_references_and_sees_one_flipped_bit():
    jcfg = JM.TransformerConfig(hidden_size=64, num_heads=4, num_layers=2, vocab_size=96,
                                max_seq_len=32)
    tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(3), jcfg))
    state = params_from_numpy(tree)
    want = JS.host_tree_fold(tree)
    assert int(jax.jit(JS.tree_fold_metrics)(tree)[0]) == want
    assert TS.host_tree_fold(state) == want
    assert int(TS.tree_fold_metrics(state)[0]) == want
    leaf = state["embed.wte"]
    leaf.view(torch.int32).reshape(-1)[5] ^= 1 << 18
    assert TS.host_tree_fold(state) != want


# ------------------------------------------------------------ layout invariance
def _gpt(num_layers=4):
    return TM.TransformerConfig(hidden_size=64, num_heads=4, num_layers=num_layers,
                                vocab_size=96, max_seq_len=32, compute_dtype=torch.float32)


@pytest.mark.usefixtures("one_rank_group")
@pytest.mark.parametrize("transport", ["p2p", "local"])
def test_state_fold_counts_every_logical_element_once(transport):
    """World 1, and a pp 2 pipeline whose two stages one process hosts (a
    tied table on both stages): the fold of the owned shards equals the
    fold of the whole logical tree, params and Adam state."""
    cfg = _gpt()
    hp = THP.uniform(1, 4) if transport == "p2p" else THP(
        world_size=2, pp=2, layers=[TLS()] * 4, global_bsz=4, chunks=2,
        pipeline_type="pipedream_flush")
    model = construct_hybrid_parallel_model(cfg, hp, "cpu", transport=transport)
    params = model.init_params(7)
    tx, _ = get_optimizer_and_scheduler(OptimizerArgs())
    state = model.init_opt_state(tx, params)
    for st in state.values():
        for t in list(st.mu.values()) + list(st.nu.values()):
            t.normal_()
        st.count = 5
    full = model.gather_params(params)
    assert TS.state_fold(model, params) == TS.host_tree_fold(full)
    moments = model.gather_opt_state(state)
    want = TS.host_tree_fold([full, moments.mu, moments.nu]) + 5
    assert TS.state_fold(model, params, state) == want % (1 << 32)


# ----------------------------------------------------------------- the ladder
LADDER_SEQUENCES = {
    "majority_strikes_then_quarantines": (2, [[5, 5, 7, 5], [9, 9, 1, 9]], [0, 1, 2, 3]),
    "unanimous_round_resets": (2, [[5, 5, 7, 5], [6, 6, 6, 6], [8, 8, 2, 8]], [0, 1, 2, 3]),
    "changing_suspect": (2, [[5, 7, 5, 5], [5, 5, 7, 5]], [0, 1, 2, 3]),
    "tie_never_convicts": (1, [[5, 7], [5, 7]], [0, 1]),
    "two_liars_of_five": (3, [[1, 1, 2, 1, 3], [1, 1, 2, 1, 3], [4, 4, 5, 4, 6]],
                          [0, 1, 2, 3, 4]),
}


@pytest.mark.parametrize("name", sorted(LADDER_SEQUENCES))
def test_vote_ladder_matches_the_reference(name):
    strikes, rounds, ids = LADDER_SEQUENCES[name]
    ref, port = JS.VoteLadder(strikes=strikes), TS.VoteLadder(strikes=strikes)
    for votes in rounds:
        assert port.observe(votes, ids) == ref.observe(votes, ids)


VOTE_STRATEGIES = {
    "pure_dp4": dict(world_size=4, num_layers=2, global_bsz=4),
    "tp2": dict(world_size=4, num_layers=2, tp=2, global_bsz=4),
    "solo": dict(world_size=1, num_layers=2, global_bsz=2),
    "zero3": dict(world_size=4, num_layers=2, sdp=1, global_bsz=4),
    "zero2": dict(world_size=4, num_layers=2, default_dp_type="zero2", global_bsz=4),
    "pp2": dict(world_size=4, num_layers=2, pp=2, global_bsz=4),
    "vtp2": dict(world_size=4, num_layers=2, vocab_tp=2, global_bsz=4),
    "cp2": dict(world_size=4, num_layers=2, cp=2, global_bsz=4),
}


@pytest.mark.parametrize("name", sorted(VOTE_STRATEGIES))
def test_vote_reason_matches_the_reference(name):
    kw = VOTE_STRATEGIES[name]
    assert TS.vote_reason(THP.uniform(**kw)) == JS.vote_reason(JHP.uniform(**kw))


@pytest.mark.parametrize("kw", [
    dict(sdc_check="vote"), dict(sdc_check="off", sdc_interval=10),
    dict(autotune="apply", elastic_strategy="s.json"), dict(autotune_margin=0.1),
    dict(autotune="observe"),
])
@pytest.mark.parametrize("strategy", ["tp2", "pure_dp4", "pp2"])
def test_sentinel_and_autotune_lint_match_the_reference(kw, strategy):
    s = VOTE_STRATEGIES[strategy]
    got = [(d.code, d.key) for d in TLint.lint_hp(THP.uniform(**s), **kw).diagnostics
           if d.key in ("sdc_check", "sdc_interval", "autotune", "autotune_margin")]
    want = [(d.code, d.key) for d in JL.lint_hp(JHP.uniform(**s), **kw).diagnostics
            if d.key in ("sdc_check", "sdc_interval", "autotune", "autotune_margin")]
    assert got == want


# ------------------------------------------------------------------ continuity
def test_assert_digest_continuity_passes_and_refuses():
    tree = {"w": torch.arange(12.0).reshape(3, 4)}
    fold = TS.host_tree_fold(tree)
    assert TS.assert_digest_continuity(fold, tree, "test(noop)") == fold
    assert TS.assert_digest_continuity(fold, fold, "test(int)") == fold
    garbled = {"w": tree["w"].clone()}
    garbled["w"][1, 1] = 99.0
    with pytest.raises(TD.DiagnosticError) as err:
        TS.assert_digest_continuity(fold, garbled, "test(garbled)")
    assert [d.code for d in err.value.diagnostics] == ["GLS016"]
    assert "test(garbled)" in err.value.diagnostics[0].message


TINY = ["--model_type", "gpt", "--set_model_config_manually", "1", "--hidden_size", "64",
        "--num_attention_heads", "4", "--num_layers", "4", "--vocab_size", "96",
        "--seq_length", "32", "--global_train_batch_size", "4", "--chunks", "2",
        "--mixed_precision", "fp32", "--lr", "1e-2", "--device", "cpu", "--log_interval", "100"]


def _train(extra, hooks=None):
    from galvatron_tpu_torch.cli import train as T

    args = T.initialize_galvatron(argv=TINY + extra, mode="train")
    args.fault_hooks = hooks
    return T.train(args)


def test_digest_is_bitwise_transparent_and_the_manifest_holds_the_fold(tmp_path):
    """A digest run's losses are the plain run's bit for bit; its saves
    record the state's folds in the manifest, equal to the fold of the
    checkpoint's tensors; a hosted-pipeline restore across strategies under
    sdc_check passes the manifest's folds, and a tampered fold refuses it
    (GLS016)."""
    ckpt = str(tmp_path / "c")
    plain = _train(["--train_iters", "4"])
    digest = _train(["--train_iters", "4", "--sdc_check", "digest", "--save", ckpt])
    assert digest["losses"] == plain["losses"]
    assert digest["resilience"]["sdc_checks"] == 4
    manifest = TC.read_manifest(ckpt, 4)
    full, _ = TC.load_full_params(ckpt, 4, _gpt())
    assert manifest["items"]["params"]["fold"] == TS.host_tree_fold(full)
    assert manifest["items"]["opt_state"]["fold"] is not None
    with TDIST.process_group("cpu"):
        hp = THP(world_size=2, pp=2, layers=[TLS()] * 4, global_bsz=4, chunks=2,
                 pipeline_type="pipedream_flush")
        cfg = _gpt()
        cfg.param_dtype = torch.float32
        model = construct_hybrid_parallel_model(cfg, hp, "cpu", transport="local")
        params = model.init_params(0)
        tx, _ = get_optimizer_and_scheduler(OptimizerArgs())
        state = model.init_opt_state(tx, params)
        TC.load_checkpoint(ckpt, 4, params_target=params, opt_state_target=state,
                           target=model, allow_cross=True, sdc_check=True)
        path = TC._manifest_path(ckpt, 4)
        with open(path) as f:
            m = json.load(f)
        m["items"]["params"]["fold"] = (m["items"]["params"]["fold"] + 1) % (1 << 32)
        with open(path, "w") as f:
            json.dump(m, f)
        with pytest.raises(TD.DiagnosticError) as err:
            TC.load_checkpoint(ckpt, 4, params_target=params, opt_state_target=state,
                               target=model, allow_cross=True, sdc_check=True)
        assert "GLS016" in [d.code for d in err.value.diagnostics]


@pytest.mark.usefixtures("one_rank_group")
def test_vote_is_refused_without_replicas_and_digest_composes_with_the_guard():
    cfg = _gpt(2)
    model = construct_hybrid_parallel_model(cfg, THP.uniform(1, 2), "cpu")
    tx, _ = get_optimizer_and_scheduler(OptimizerArgs())
    with pytest.raises(ValueError, match="dp=1"):
        model.make_train_step(tx, sdc_check="vote")
    with pytest.raises(ValueError, match="sdc_check must be one of"):
        model.make_train_step(tx, sdc_check="crc")
    step = model.make_train_step(tx, guard_anomalies=True, sdc_check="digest")
    params = model.init_params(1)
    state = model.init_opt_state(tx, params)
    tokens = torch.randint(0, 96, (4, 32), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1),
             "positions": torch.arange(32).expand(4, 32),
             "loss_mask": torch.full((4, 32), float("nan"))}
    before = TS.host_tree_fold(params)
    params, state, m = step(params, state, batch, float("inf"))
    assert m["anomalous"]  # kept old: the digest is of the unchanged params
    assert TS.fold_value(m["sdc_fold"])[0] == before


# ---------------------------------------------------------- migration refusals
class _Args:
    elastic_memory_gb = None
    model_type = "gpt"
    config_dir = None

    def __init__(self, strategy=None, budget=None):
        self.elastic_strategy = strategy
        self.elastic_memory_gb = budget


@pytest.mark.usefixtures("one_rank_group")
def test_migration_to_another_global_batch_is_refused():
    model = construct_hybrid_parallel_model(_gpt(2), THP.uniform(1, 2, global_bsz=4), "cpu")
    with pytest.raises(TD.DiagnosticError, match="GLS207"):
        TE.migrate(model, {}, {}, THP.uniform(1, 2, global_bsz=8))


@pytest.mark.usefixtures("one_rank_group")
def test_own_tree_family_across_pipeline_layouts_is_refused():
    from galvatron_tpu_torch.models.t5 import t5_config

    cfg = t5_config("t5-test", compute_dtype=torch.float32, hidden_size=32, num_heads=2,
                    head_dim=16, num_enc_layers=2, num_dec_layers=2, ffn_hidden=64,
                    vocab_size=64, max_seq_len=16)
    from galvatron_tpu_torch.models.registry import get_family

    model = get_family("t5").build(cfg, THP.uniform(1, 4, global_bsz=4), "cpu")
    pp2 = THP(world_size=2, pp=2, layers=[TLS()] * 4, global_bsz=4, chunks=2,
              pipeline_type="pipedream_flush")
    with pytest.raises(TD.DiagnosticError, match="GLS207"):
        TE.migrate(model, {}, {}, pp2)


def test_resolve_migration_strategy_takes_the_file_and_guards_the_batch(tmp_path):
    current = THP.uniform(2, 4, global_bsz=4)
    spath = str(tmp_path / "target.json")
    THP.uniform(2, 4, tp=2, global_bsz=4).save(spath)
    hp, action = TE.resolve_migration_strategy(_Args(spath), _gpt(), 2, current)
    assert action == "strategy_file" and hp.layers[0].tp == 2
    assert hp.scan_layers == current.scan_layers
    THP.uniform(2, 4, global_bsz=8).save(spath)
    with pytest.raises(TD.DiagnosticError, match="GLS207"):
        TE.resolve_migration_strategy(_Args(spath), _gpt(), 2, current)


def test_resolve_migration_search_respects_the_budget():
    cfg = TM.TransformerConfig(hidden_size=256, num_heads=4, num_layers=4, vocab_size=4096,
                               max_seq_len=512)
    with pytest.raises(TD.DiagnosticError, match="GLS203"):
        TE.resolve_migration_strategy(_Args(budget=1e-4), cfg, 2,
                                      THP.uniform(8, 4, global_bsz=8))
