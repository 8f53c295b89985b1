"""Port parity, checkpoint conversion and corpus tokenization on the CPU
(``tools/convert_checkpoint.py``, ``tools/tokenize_corpus.py``, the
params-only ``--load`` of ``cli train`` and ``cli serve``):

- h2g of a tiny seeded LLaMA in an HF model directory
  (``pytorch_model.bin``, or ``model.safetensors`` read by the port's own
  reader) writes a
  params-only step 0 whose params equal the converted ones bit for bit;
  ``cli train --device cpu --load`` of it takes the same steps, losses bit
  for bit, as the same run started from those params in memory (a fresh
  optimizer from iteration 0), under the strategy of the conversion and
  under another one (tp 2 and ZeRO-3 at world 2 rides
  ``tests/test_torch_parallel.py``); a step with Adam state still refuses
  another strategy without ``--elastic`` (GLS206);
- ``cli serve --load`` of it gives the greedy tokens of serving the
  in-memory params;
- g2h through the CLI gives back the HF tensors bit for bit (fp32), of the
  converted step and of a trained one;
- ``tokenize_corpus`` writes ``.bin`` / ``.idx.npy`` byte-equal to the JAX
  tool's in every ``--doc-sep`` mode, refuses ``--append-eod`` without an
  EOD id, and a failed rerun never leaves a stale index beside a new
  ``.bin``.
"""

import json
import os

import numpy as np
import pytest
import torch

from galvatron_tpu_torch.analysis.diagnostics import DiagnosticError
from galvatron_tpu_torch.cli import serve as TS
from galvatron_tpu_torch.cli import train as T
from galvatron_tpu_torch.models import hf_utils as H
from galvatron_tpu_torch.models.llama import llama_config_from_hf
from galvatron_tpu_torch.runtime import checkpoint as ck
from galvatron_tpu_torch.runtime.model_api import HybridParallelModel
from galvatron_tpu_torch.tools import convert_checkpoint as C
from galvatron_tpu_torch.tools import tokenize_corpus as TK

SEQ = 32
MODEL = ["--model_type", "llama", "--set_model_config_manually", "1", "--hidden_size", "64",
         "--num_attention_heads", "4", "--ffn_hidden_size", "128", "--num_layers", "2",
         "--vocab_size", "128", "--seq_length", str(SEQ), "--device", "cpu"]
TRAIN = MODEL + ["--global_train_batch_size", "4", "--chunks", "2", "--train_iters", "3",
                 "--lr", "1e-3", "--lr_decay_style", "constant", "--log_interval", "100",
                 "--mixed_precision", "fp32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HF_CONFIG = {"model_type": "llama", "architectures": ["LlamaForCausalLM"], "hidden_size": 64,
             "num_attention_heads": 4, "num_hidden_layers": 2, "intermediate_size": 128,
             "vocab_size": 128, "max_position_embeddings": SEQ}


@pytest.fixture(scope="module")
def hf_llama(tmp_path_factory):
    """A tiny LLaMA from seeded port parameters, exported to an HF model
    directory as ``save_pretrained`` lays it out (a ``config.json`` of the
    non-default keys; ``pytorch_model.bin`` or ``model.safetensors``), and
    the h2g of each (the exporter is held against transformers in
    tests/test_torch_hf.py)."""
    from galvatron_tpu_torch.config.strategy import HybridParallelConfig
    from galvatron_tpu_torch.models.llama import export_hf_llama
    from galvatron_tpu_torch.runtime.model_api import construct_hybrid_parallel_model

    root = tmp_path_factory.mktemp("hf")
    (root / "config.json").write_text(json.dumps(HF_CONFIG))
    cfg = llama_config_from_hf(H.read_hf_config(str(root), "llama"))
    model = construct_hybrid_parallel_model(cfg, HybridParallelConfig.uniform(1, 2), "cpu")
    params = {n: p.detach().clone() for n, p in model.init_params(7)[0].named_parameters()}
    sd = {k: torch.from_numpy(v) for k, v in export_hf_llama(params, cfg).items()}
    out = {"sd": sd, "cfg": cfg, "params": params}
    for fmt in ("bin", "safetensors"):
        d = root / fmt
        d.mkdir()
        (d / "config.json").write_text(json.dumps(HF_CONFIG))
        if fmt == "bin":
            torch.save(sd, str(d / "pytorch_model.bin"))
        else:
            H.write_safetensors(str(d / "model.safetensors"), sd)
        ckpt = str(root / ("ckpt_" + fmt))
        C.main(["h2g", "--model_type", "llama", "--hf_path", str(d), "--output_dir", ckpt])
        out[fmt] = dict(dir=str(d), ckpt=ckpt)
    return out


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_h2g_writes_a_params_only_step_zero_of_the_converted_params(fmt, hf_llama):
    ckpt = hf_llama[fmt]["ckpt"]
    assert ck.intact_iterations(ckpt) == [0]
    manifest = ck.read_manifest(ckpt, 0)
    assert "opt_state" not in manifest["items"] and manifest["provenance"]["strategy"]
    full, meta = ck.load_full_params(ckpt, None, hf_llama["cfg"])
    assert meta == {"iteration": 0, "source": "hf", "model_type": "llama"}
    assert sorted(full) == sorted(hf_llama["params"])
    for n, t in hf_llama["params"].items():
        assert torch.equal(full[n], t), n


def _from_memory(monkeypatch, full):
    """Runs that build their model start from `full` instead of a seeded
    init."""
    monkeypatch.setattr(HybridParallelModel, "init_params",
                        lambda self, seed: self.shard_params(full))


def test_train_load_of_the_conversion_continues_as_the_in_memory_run(hf_llama, monkeypatch,
                                                                    tmp_path, capsys):
    """The same losses, bit for bit, as the run started from the converted
    params in memory (so the optimizer starts fresh at iteration 0), under
    the conversion's strategy and, within 1e-5 (another order of the same
    sums), under another one (ZeRO-3 with a remat layer)."""
    loaded = T.main(TRAIN + ["--load", hf_llama["bin"]["ckpt"]])
    assert "iteration 0 (params only: a fresh optimizer)" in capsys.readouterr().out
    assert loaded["checkpoint_restore"]["params_only"]
    strategy = tmp_path / "zero3.json"
    strategy.write_text(json.dumps({"pp_deg": 1, "tp_sizes_enc": "1,1",
                                    "tp_consecutive_flags": "1,1", "dp_types_enc": "1,0",
                                    "checkpoint": "1,0", "global_bsz": 4, "chunks": 2}))
    other = T.main(TRAIN + ["--load", hf_llama["safetensors"]["ckpt"],
                            "--galvatron_config_path", str(strategy)])
    with monkeypatch.context() as m:
        _from_memory(m, hf_llama["params"])
        memory = T.main(TRAIN)
    assert loaded["losses"] == memory["losses"] and len(memory["losses"]) == 3
    np.testing.assert_allclose(other["losses"], memory["losses"], rtol=1e-5)


def test_a_checkpoint_with_adam_state_still_refuses_another_strategy(tmp_path):
    T.main(TRAIN + ["--train_iters", "1", "--save", str(tmp_path / "ck")])
    with pytest.raises(DiagnosticError) as e:
        T.train(T.initialize_galvatron(argv=TRAIN + ["--load", str(tmp_path / "ck"),
                                                     "--checkpoint", "1"], mode="train"))
    assert e.value.diagnostics[0].code == "GLS206"


def test_serve_load_of_the_conversion_gives_the_in_memory_greedy_tokens(hf_llama,
                                                                       monkeypatch):
    from galvatron_tpu_torch.serve import engine as E

    outputs = []
    run = E.ContinuousBatcher.run

    def recorded(self, reqs):
        done = run(self, reqs)
        outputs.append(sorted((r.rid, [int(t) for t in r.output]) for r in done))
        return done

    monkeypatch.setattr(E.ContinuousBatcher, "run", recorded)
    argv = MODEL + ["--num_requests", "3", "--prompt_len_min", "4", "--prompt_len_max", "10",
                    "--max_new_tokens", "4"]
    TS.main(argv + ["--load", hf_llama["bin"]["ckpt"]])
    _from_memory(monkeypatch, hf_llama["params"])
    TS.main(argv)
    assert outputs[0] == outputs[1] and len(outputs[0]) == 3


def test_g2h_round_trips_through_the_cli(hf_llama, tmp_path):
    out = str(tmp_path / "back.bin")
    C.main(["g2h", "--model_type", "llama", "--hf_config_path", hf_llama["bin"]["dir"],
            "--checkpoint_dir", hf_llama["safetensors"]["ckpt"], "--output_path", out])
    back = torch.load(out, weights_only=True)
    sd = hf_llama["sd"]
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        assert v.dtype == torch.float32 and torch.equal(v, sd[k]), k
    trained = str(tmp_path / "trained")
    T.main(TRAIN + ["--load", hf_llama["bin"]["ckpt"], "--save", trained])
    C.main(["g2h", "--model_type", "llama", "--hf_config_path", hf_llama["bin"]["dir"],
            "--checkpoint_dir", trained, "--output_path", out])
    full, _ = ck.load_full_params(trained, None, hf_llama["cfg"])
    back = torch.load(out, weights_only=True)
    assert torch.equal(back["model.layers.1.mlp.up_proj.weight"],
                       full["layers.1.wi.kernel"][:, 1].t())
    assert not torch.equal(back["model.norm.weight"], sd["model.norm.weight"])


def test_a_conversion_under_another_shape_is_refused(hf_llama):
    """Read by name and shape (as the train CLI reads a conversion),
    another shape refuses (GLS202); read strictly, the model digest does
    (GLS201)."""
    import dataclasses

    cfg = dataclasses.replace(hf_llama["cfg"], ffn_hidden=96)
    with pytest.raises(DiagnosticError) as e:
        ck.load_full_params(hf_llama["bin"]["ckpt"], None, cfg, strict_model=False)
    assert e.value.diagnostics[0].code == "GLS202"
    with pytest.raises(DiagnosticError) as e:
        ck.load_full_params(hf_llama["bin"]["ckpt"], None, cfg)
    assert e.value.diagnostics[0].code == "GLS201"


# ------------------------------------------------------------ tokenization
TEXT = ("the quick brown fox 0\nünïcödé line\n\n\npara two a\npara two b\n\n   \n"
        "last line with trailing spaces   \n")


@pytest.mark.parametrize("doc_sep", ["line", "blank-line", "file"])
@pytest.mark.parametrize("append_eod", [False, True])
def test_tokenize_corpus_writes_the_jax_tools_bytes(doc_sep, append_eod, tmp_path):
    from galvatron_tpu.tools import tokenize_corpus as JK

    files = []
    for i in range(2):
        f = tmp_path / ("in%d.txt" % i)
        f.write_text(TEXT * (i + 1), encoding="utf-8")
        files.append(str(f))
    stats = {name: mod.tokenize_corpus(files, str(tmp_path / name), "bytes", doc_sep,
                                       append_eod) for name, mod in (("jax", JK), ("torch", TK))}
    assert stats["torch"] == stats["jax"]
    for ext in (".bin", ".idx.npy"):
        with open(str(tmp_path / "jax") + ext, "rb") as f, \
                open(str(tmp_path / "torch") + ext, "rb") as g:
            assert g.read() == f.read(), ext


def test_tokenize_cli_eod_refusal_and_no_stale_index(tmp_path, capsys):
    from galvatron_tpu_torch.data.dataset import IndexedDataset

    txt = tmp_path / "a.txt"
    txt.write_text("hello world\nsecond\n", encoding="utf-8")
    prefix = str(tmp_path / "ds")
    stats = TK.main(["--input", str(txt), "--output", prefix, "--append-eod"])
    assert stats == {"n_docs": 2, "n_tokens": 19, "vocab_size": 257}
    assert "--data_path %s" % prefix in capsys.readouterr().out
    assert list(IndexedDataset(prefix).doc(1)) == list(b"second") + [256]

    class NoEod(TK.ByteTokenizer):
        eod_id = None

    with pytest.raises(ValueError, match="no EOD id"):
        TK.tokenize_corpus([str(txt)], prefix, NoEod(), append_eod=True)
    with pytest.raises(FileNotFoundError):
        TK.tokenize_corpus([str(txt), str(tmp_path / "missing.txt")], prefix)
    assert not os.path.exists(prefix + ".idx.npy")
    assert not os.path.exists(prefix + ".bin.tmp")
    with pytest.raises(FileNotFoundError):
        IndexedDataset(prefix)
    empty = tmp_path / "empty.txt"
    empty.write_text("\n\n", encoding="utf-8")
    with pytest.raises(ValueError, match="no non-empty documents"):
        TK.tokenize_corpus([str(empty)], prefix)


def test_hf_tokenizer_without_transformers_raises_instead_of_bytes(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_transformers(name, *args, **kw):
        if name == "transformers" or name.startswith("transformers."):
            raise ImportError("No module named 'transformers'")
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_transformers)
    with pytest.raises(ImportError, match="--tokenizer bytes"):
        TK.get_tokenizer("some/local/dir")
