"""Port parity, the encoder families (BERT, ViT) on the CPU against the JAX
package, from the same seeded weights (the numpy bridge) and inputs:

- BERT (post-norm, token types, embedding norm, tied MLM head) on a batch
  with a key-padding tail and token types: the MLM loss within 2e-5 of
  ``lm_loss_fn`` and every gradient within 1e-4 * max|g| + 1e-6 of
  ``jax.grad``'s; likewise ViT (patches, cls token, classification head)
  against ``classification_loss_fn``. Both at world 1 through the layout
  path too (one-rank groups), and under GPipe and 1F1B with both stages
  hosted in this process;
- the synthetic and the ``.npy``-shard vision streams equal the JAX
  package's batch for batch;
- the model profiler writes the JAX package's file names and keys for both
  families, and the flops equal the JAX package's;
- ``cli train --model_type bert|vit --device cpu`` runs 3 steps (ViT from a
  vision shard), and the GPT/LLaMA ``_fa`` aliases pin the flash path.

The layouts at world 2 and 4 (BERT under tp 2 + vocab TP + ZeRO-3, ViT
under tp 2 + ZeRO-2, 1F1B pp 2 for both) ride the workers of
``tests/test_torch_parallel.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from galvatron_tpu.models import base as JM
from galvatron_tpu.models import bert as JB
from galvatron_tpu.models import vit as JV
from galvatron_tpu_torch.models import base as TM
from galvatron_tpu_torch.models import bert as TB
from galvatron_tpu_torch.models import vit as TV
from galvatron_tpu_torch.tools.from_jax import _flatten, params_from_numpy

LOSS_TOL, GRAD_REL, GRAD_ABS = 2e-5, 1e-4, 1e-6
B = 4
BERT = dict(hidden_size=64, num_heads=4, num_layers=2, ffn_hidden=128, vocab_size=96,
            max_seq_len=32)
VIT = dict(hidden_size=64, num_heads=4, num_layers=2, ffn_hidden=128, image_size=12,
           patch_size=4, num_classes=10)  # 9 patches + cls: 10 positions


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread beside JAX's CPU backend in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(family):
    if family == "bert":
        return (JB.bert_config("bert-base", compute_dtype=jnp.float32, **BERT),
                TB.bert_config("bert-base", compute_dtype=torch.float32, **BERT))
    return (JV.vit_config("vit-base", compute_dtype=jnp.float32, **VIT),
            TV.vit_config("vit-base", compute_dtype=torch.float32, **VIT))


def weights(jcfg, seed=0):
    """The JAX init with every scale and bias perturbed (so a norm or a
    bias wired wrong shows) and a non-zero cls token."""
    tree = jax.device_get(JM.init_model_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)

    def perturb(path, a):
        key = jax.tree_util.keystr(path)
        if "scale" in key or "bias" in key or "cls_token" in key:
            return np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(perturb, tree)


def batch_np(family, cfg, seed=3, rows=B):
    rng = np.random.RandomState(seed)
    if family == "vit":
        return {"pixels": rng.randn(rows, cfg.image_size, cfg.image_size,
                                    cfg.num_channels).astype(np.float32),
                "labels": rng.randint(0, cfg.num_classes, (rows,))}
    s = cfg.max_seq_len
    tokens = rng.randint(0, cfg.vocab_size, (rows, s))
    attn = np.ones((rows, s), np.float32)
    for r in range(rows):
        attn[r, s - (3 * r) % 11:] = 0.0  # key-padding tails of uneven length
    types = (np.arange(s)[None, :] >= rng.randint(4, s - 4, (rows, 1))).astype(np.int64)
    return {"tokens": tokens, "positions": np.broadcast_to(np.arange(s), (rows, s)).copy(),
            "labels": rng.randint(0, cfg.vocab_size, (rows, s)), "loss_mask": attn.copy(),
            "attn_mask": attn, "token_type_ids": types}


def jax_reference(family, jcfg, tree, b):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    fn = JM.classification_loss_fn if family == "vit" else JM.lm_loss_fn
    loss, grads = jax.jit(jax.value_and_grad(lambda p: fn(p, jb, jcfg)))(tree)
    flat = {}
    _flatten(jax.device_get(grads), "", flat)
    return float(loss), {n: np.asarray(v) for n, v in flat.items()}


def torch_batch(b, device="cpu"):
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in b.items()}


def assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        err = float(np.abs(np.asarray(got[n]) - w).max())
        assert err <= GRAD_REL * np.abs(w).max() + GRAD_ABS, (n, err, np.abs(w).max())


@pytest.fixture(scope="module", params=["bert", "vit"])
def family_case(request):
    family = request.param
    jcfg, tcfg = configs(family)
    tree = weights(jcfg)
    b = batch_np(family, tcfg)
    loss, grads = jax_reference(family, jcfg, tree, b)
    return dict(family=family, jcfg=jcfg, tcfg=tcfg, tree=tree, batch=b, loss=loss,
                grads=grads)


def test_loss_and_every_gradient_match_the_jax_package(family_case):
    c = family_case
    params = TM.TransformerLM(c["tcfg"], "cpu")
    params.load_state_dict(params_from_numpy(c["tree"]))
    loss = TM.loss_fn(params, torch_batch(c["batch"]), c["tcfg"])
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - c["loss"]) <= LOSS_TOL, (loss, c["loss"])
    assert_grads_close({n: p.grad.numpy() for n, p in params.named_parameters()}, c["grads"])


# world-1 strategies through the layout path: one-rank groups; the
# pipelines host both stages in this process (LocalTransport)
_L = dict
STRATEGIES = {
    "zero3_zero2_remat": dict(layers=[_L(fsdp=1, checkpoint=1), _L()], chunks=2,
                              default_dp_type="zero2"),
    "gpipe_pp2": dict(pp=2, layers=[_L(checkpoint=1), _L(checkpoint=1)], chunks=2),
    "1f1b_pp2": dict(pp=2, layers=[_L(fsdp=1), _L(checkpoint=1)], chunks=2,
                     pipeline_type="pipedream_flush"),
}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_world_one_layouts_and_pipelines_match_the_jax_package(strategy, family_case):
    """The layout path's loss and gathered gradients of the family's batch
    (chunks 2: the micro-batches weighted by their valid tokens, or equally
    for classification) within the limits above."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig, LayerStrategy
    from galvatron_tpu_torch.runtime import distributed as TDIST
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    c, kw = family_case, dict(STRATEGIES[strategy])
    layers = [LayerStrategy(**s) for s in kw.pop("layers")]
    pp = kw.pop("pp", 1)  # a hosted pipeline: one device per stage
    hp = HybridParallelConfig(world_size=pp, pp=pp, layers=layers, global_bsz=B, **kw)
    with TDIST.process_group("cpu") as dev:
        model = construct_hybrid_parallel_model(
            c["tcfg"], hp, dev, transport="local" if hp.pp > 1 else "p2p")
        params = model.shard_params(params_from_numpy(c["tree"]))
        loss, grads = model.loss_and_grads(params, torch_batch(c["batch"]))
        full = {n: g.numpy() for n, g in model.gather_grads(grads).items()}
    assert abs(float(loss) - c["loss"]) <= LOSS_TOL, (float(loss), c["loss"])
    assert_grads_close(full, c["grads"])


# ------------------------------------------------------------------ vision data
def test_synthetic_and_shard_vision_streams_equal_the_jax_packages(tmp_path):
    from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
    from galvatron_tpu.data import dataset as JDS
    from galvatron_tpu.runtime import dataloader as JDL
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig as THP
    from galvatron_tpu_torch.data import dataset as TDS
    from galvatron_tpu_torch.runtime import dataloader as TDL

    jhp, thp = JHP.uniform(1, 2, global_bsz=3), THP.uniform(1, 2, global_bsz=3)
    rng = np.random.RandomState(0)
    prefix = str(tmp_path / "images")
    TDS.write_vision_dataset(prefix, rng.randint(0, 256, (40, 12, 12, 3)).astype(np.uint8),
                             rng.randint(0, 10, 40))
    streams = [
        (JDL.get_vision_train_iterator(jhp, 12, 3, 10, seed=5, start_step=2),
         TDL.get_vision_train_iterator(thp, 12, 3, 10, seed=5, start_step=2)),
        (JDS.vision_data_iterator(prefix, jhp, 12, 3, seed=7, start_step=11, split="train",
                                  split_weights="8,1,1"),
         TDS.vision_data_iterator(prefix, thp, 12, 3, seed=7, start_step=11, split="train",
                                  split_weights="8,1,1")),
        (JDS.vision_data_iterator(prefix, jhp, 12, 3, seed=7, split="valid",
                                  split_weights="8,1,1"),
         TDS.vision_data_iterator(prefix, thp, 12, 3, seed=7, split="valid",
                                  split_weights="8,1,1")),
    ]
    for j_it, t_it in streams:
        for _ in range(3):  # 3 x 3 rows pass an epoch of the 32-image train split
            jb, tb = next(j_it), next(t_it)
            assert sorted(jb) == sorted(tb) == ["labels", "pixels"]
            np.testing.assert_array_equal(tb["pixels"].numpy(), np.asarray(jb["pixels"]))
            np.testing.assert_array_equal(tb["labels"].numpy(), np.asarray(jb["labels"]))
            assert tb["pixels"].dtype == torch.float32


# ------------------------------------------------------------ profiler, flops
def _stub(calls, seq):
    """One `_walltime` for either package's model profiler: seconds as a
    function of the timed program's (layers, batch, sequence) and of the
    call's index (as ``tests/test_torch_profile.py``'s, with pixel
    batches counted at the model's sequence)."""

    def stub(fn, args, *rest):
        a0, a1 = args[0], args[1]
        if isinstance(a1, dict):
            n = len(a0["layers"]) if isinstance(a0, dict) else len(a0.layers)
            bsz, s = (a1["pixels"].shape[0], seq) if "pixels" in a1 else a1["tokens"].shape
        else:
            n = len(a0)
            bsz, s = a1.shape[:2]
        calls.append((n, int(bsz), int(s)))
        return 1e-3 * (0.5 + 0.7 * n * bsz * (s / 64.0) ** 1.3) + 2e-5 * len(calls) ** 2

    return stub


def _keys(tree):
    if isinstance(tree, dict):
        return {str(k): _keys(v) for k, v in tree.items()}
    return None


def test_profiler_writes_the_jax_packages_files_and_keys(family_case, monkeypatch, tmp_path):
    """Both packages' model profilers on the family under one timer stub:
    equal computation tables, file names, memory-table keys, parameter
    size and model states."""
    import galvatron_tpu.profiler.model as JPM
    import galvatron_tpu_torch.profiler.model as TPM

    c = family_case
    common = dict(profile_batch_size=2, layernum_min=1, layernum_max=2, max_tp_deg=2,
                  mixed_precision="fp32", warmup=1, iters=1)
    jp = JPM.ModelProfiler(c["jcfg"], c["family"], JPM.ModelProfileArgs(
        config_dir=str(tmp_path / "jax"), **common))
    tp = TPM.ModelProfiler(c["tcfg"], c["family"], TPM.ModelProfileArgs(
        device="cpu", config_dir=str(tmp_path / "torch"), **common))
    j_calls, t_calls = [], []
    monkeypatch.setattr(JPM, "_walltime", _stub(j_calls, c["tcfg"].max_seq_len))
    monkeypatch.setattr(TPM, "_walltime", _stub(t_calls, c["tcfg"].max_seq_len))
    monkeypatch.setattr(JPM.ModelProfiler, "_act_bytes_tp", lambda self, *a, **k: None)
    j_out, t_out = jp.profile_all(write=True), tp.profile_all(write=True)
    assert t_calls == j_calls
    assert t_out["computation"] == j_out["computation"]
    assert [p.replace("torch", "jax") for p in tp.config_paths().values()] == \
        list(jp.config_paths().values())
    jm, tm = j_out["memory"], t_out["memory"]
    assert _keys(tm) == _keys(jm)
    assert tm["layertype_0"]["parameter_size"] == jm["layertype_0"]["parameter_size"]
    assert tm["other_memory_pp_off"]["model_states"] == jm["other_memory_pp_off"]["model_states"]
    assert (tm["other_memory_pp_on"]["last_stage"]["model_states"]
            == jm["other_memory_pp_on"]["last_stage"]["model_states"])


@pytest.mark.parametrize("size", ["bert-base", "bert-large", "vit-base", "vit-huge"])
def test_flops_equal_the_jax_packages(size):
    from galvatron_tpu.obs import flops as JFL
    from galvatron_tpu_torch.obs import flops as TFL

    fam = size.split("-")[0]
    j = (JB.bert_config if fam == "bert" else JV.vit_config)(size)
    t = (TB.bert_config if fam == "bert" else TV.vit_config)(size)
    assert dataclasses.asdict(t).keys() == dataclasses.asdict(j).keys()
    assert TFL.train_step_flops(t, 8) == JFL.train_step_flops(j, 8)
    assert TFL.model_fwd_flops(t, 2) == JFL.model_fwd_flops(j, 2)


# ------------------------------------------------------------------------- CLI
ENCODER_ARGV = ["--set_model_config_manually", "1", "--hidden_size", "64",
                "--num_attention_heads", "4", "--ffn_hidden_size", "128", "--num_layers", "2",
                "--global_train_batch_size", "4", "--chunks", "2", "--train_iters", "3",
                "--device", "cpu", "--lr", "1e-3", "--log_interval", "100"]


@pytest.mark.parametrize("family", ["bert", "vit"])
def test_cli_train_runs_the_encoder_families(family, tmp_path):
    """``cli train`` on the CPU: BERT on the synthetic token stream at seq
    32, ViT (224 x 224 images, 197 positions) from a uint8 vision shard;
    three finite losses, zero flash launches (head_dim 16 is no kernel
    shape), and the summary's tokens/s counts the family's sequence."""
    from galvatron_tpu_torch.cli import train as T
    from galvatron_tpu_torch.data.dataset import write_vision_dataset

    argv = ["--model_type", family] + ENCODER_ARGV
    if family == "vit":
        rng = np.random.RandomState(0)
        write_vision_dataset(str(tmp_path / "shard"),
                             rng.randint(0, 256, (24, 224, 224, 3)).astype(np.uint8),
                             rng.randint(0, 1000, 24))
        argv += ["--data_path", str(tmp_path / "shard"), "--split", "1,0,0"]
    else:
        argv += ["--vocab_size", "96", "--seq_length", "32"]
    summary = T.main(argv)
    assert len(summary["losses"]) == 3 and np.isfinite(summary["losses"]).all()
    assert summary["flash_routes"] == [{"fwd": {}, "bwd": {}}]
    seq = 197 if family == "vit" else 32
    assert summary["tokens_per_s"] == summary["samples_per_s"] * seq


def test_serve_refuses_the_encoder_families():
    from galvatron_tpu_torch.cli import serve as S

    with pytest.raises(ValueError, match="causal-LM families only"):
        S.main(["--model_type", "bert", "--device", "cpu"] + ENCODER_ARGV[:10])


def test_registry_takes_the_ported_families_and_pins_the_fa_aliases():
    from galvatron_tpu.models import registry as JR
    from galvatron_tpu_torch.models.registry import get_family

    for name in ("gpt_fa", "llama_fa", "bert", "vit", "t5", "swin"):
        fam, jfam = get_family(name), JR.get_family(name)
        assert (fam.default_size, fam.data_kind) == (jfam.default_size, jfam.data_kind)
        assert (fam.mid_stage_type_boundaries, fam.supports_sequence_sharding) == (
            jfam.mid_stage_type_boundaries, jfam.supports_sequence_sharding)
        assert (fam.build is None) == (jfam.build is None)
        got, want = (dataclasses.asdict(f.config_fn(f.default_size)) for f in (fam, jfam))
        for d in (got, want):
            d.pop("compute_dtype"), d.pop("param_dtype")
        assert got == want
    assert get_family("gpt_fa").config_fn("gpt-0.3b").attn_impl == "flash"
