"""The port's indexed dataset (``galvatron_tpu_torch/data/dataset.py``) on the
CPU: its native index helper (the port's own copy of the C++ source, built
with g++ at first use) against the plain numpy versions and the JAX
package's helper, the language-model cases of the reference's
tests/data/test_indexed_dataset.py, and batch parity: for one corpus
written by each package, the two packages' iterators yield bitwise-equal
token and label batches for every split, blend and start step."""

import os

import numpy as np
import pytest

from galvatron_tpu.config.strategy import HybridParallelConfig as JHP
from galvatron_tpu.data import dataset as JD
from galvatron_tpu_torch.config.strategy import HybridParallelConfig
from galvatron_tpu_torch.data import dataset as D
from galvatron_tpu_torch.data.dataset import (
    GPTDataset,
    IndexedDataset,
    build_sample_idx,
    gpt_data_iterator,
    gpt_train_iterator,
    split_doc_ids,
    write_indexed_dataset,
)


def _docs(rng, n_docs=20, vocab=97):
    return [rng.randint(0, vocab, rng.randint(3, 40)).tolist() for _ in range(n_docs)]


def test_native_helper_builds_from_the_ports_source_into_build_dir():
    so = D.build()
    assert os.path.exists(so)
    assert os.path.dirname(so).endswith(os.path.join("build", "galvatron_tpu_torch"))
    assert D.SOURCE.endswith(os.path.join("galvatron_tpu_torch", "data", "csrc",
                                          "index_helpers.cpp"))
    assert D._load_helpers() is not None


def test_failed_build_raises(tmp_path, monkeypatch):
    """No quiet numpy fallback: a compiler that fails (or is missing) raises."""
    monkeypatch.setattr(D, "library_path", lambda: str(tmp_path / "index_helpers_x.so"))
    monkeypatch.setattr(D, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        D.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot build"):
        D.build()
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())


def test_sample_idx_native_matches_plain_and_jax_package():
    rng = np.random.RandomState(0)
    doc_lens = rng.randint(1, 50, 30).astype(np.int32)
    doc_idx = np.concatenate([rng.permutation(30), rng.permutation(30)]).astype(np.int32)
    native = build_sample_idx(doc_lens, doc_idx, seq_len=16, n_samples=40)
    np.testing.assert_array_equal(native, D._build_sample_idx_py(doc_lens, doc_idx, 16, 40))
    np.testing.assert_array_equal(native, JD.build_sample_idx(doc_lens, doc_idx, 16, 40))
    # more samples than the tokens hold: the walk stops where the reference's does
    short = build_sample_idx(doc_lens, doc_idx, seq_len=64, n_samples=10_000)
    np.testing.assert_array_equal(short, D._build_sample_idx_py(doc_lens, doc_idx, 64, 10_000))


def test_sample_windows_cover_stream_in_order(tmp_path):
    """Concatenating the sample windows in sample_idx order reproduces the
    doc_idx token walk."""
    rng = np.random.RandomState(1)
    docs = _docs(rng)
    path = str(tmp_path / "corpus")
    write_indexed_dataset(path, docs)
    idx = IndexedDataset(path)
    assert idx.n_docs == len(docs)
    np.testing.assert_array_equal(idx.doc(3), np.asarray(docs[3], np.int32))
    ds = GPTDataset(idx, seq_len=16, n_samples=10, seed=7)
    inv = np.argsort(ds.shuffle_idx)
    walk = np.concatenate([idx.doc(d) for d in ds.doc_idx])
    for raw_i in range(len(ds)):
        row = ds[int(inv[raw_i])]
        np.testing.assert_array_equal(row[:16], walk[raw_i * 16: raw_i * 16 + 16])


def test_iterator_deterministic_and_resumable(tmp_path):
    rng = np.random.RandomState(2)
    path = str(tmp_path / "corpus")
    write_indexed_dataset(path, _docs(rng, n_docs=40))
    hp = HybridParallelConfig.uniform(1, 2, global_bsz=4)
    it1 = gpt_train_iterator(path, hp, seq_len=16, seed=5, n_samples=100)
    first = [next(it1) for _ in range(4)]
    resumed = next(gpt_train_iterator(path, hp, seq_len=16, seed=5, n_samples=100,
                                      start_step=2))
    for k in ("tokens", "labels", "positions"):
        assert first[2][k].equal(resumed[k])


def test_labels_are_shifted_inputs(tmp_path):
    rng = np.random.RandomState(3)
    path = str(tmp_path / "corpus")
    write_indexed_dataset(path, _docs(rng))
    hp = HybridParallelConfig.uniform(1, 2, global_bsz=2)
    b = next(gpt_train_iterator(path, hp, seq_len=12, seed=0, n_samples=50))
    tokens, labels = b["tokens"].numpy(), b["labels"].numpy()
    assert tokens.shape == labels.shape == (2, 12)
    assert "loss_mask" not in b  # every target of a corpus window is real
    row0 = GPTDataset(IndexedDataset(path), 12, 50, seed=0)[0]
    np.testing.assert_array_equal(tokens[0], row0[:-1])
    np.testing.assert_array_equal(labels[0], row0[1:])


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="indexed dataset"):
        IndexedDataset(str(tmp_path / "nope"))


def test_split_doc_ids_partition():
    splits = split_doc_ids(100, "90,5,5")
    assert [len(splits[k]) for k in ("train", "valid", "test")] == [90, 5, 5]
    allids = np.concatenate([splits["train"], splits["valid"], splits["test"]])
    np.testing.assert_array_equal(np.sort(allids), np.arange(100))
    for n, w in ((100, "90,5,5"), (4000, "969,30,1"), (7, "1,1,1")):
        ours, theirs = split_doc_ids(n, w), JD.split_doc_ids(n, w)
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
    with pytest.raises(ValueError, match="three non-negative"):
        split_doc_ids(100, "90,10")


def test_split_streams_disjoint_and_deterministic(tmp_path):
    rng = np.random.RandomState(7)
    path = str(tmp_path / "corpus")
    write_indexed_dataset(path, _docs(rng, n_docs=60))
    hp = HybridParallelConfig.uniform(1, 2, global_bsz=2)
    kw = dict(seq_len=16, seed=5, n_samples=64, split_weights="70,20,10")
    tr = next(gpt_data_iterator(path, hp, split="train", **kw))
    va = next(gpt_data_iterator(path, hp, split="valid", **kw))
    va2 = next(gpt_data_iterator(path, hp, split="valid", **kw))
    assert va["tokens"].equal(va2["tokens"])
    assert not tr["tokens"].equal(va["tokens"])
    indexed = IndexedDataset(path)
    docs = split_doc_ids(indexed.n_docs, "70,20,10")
    ds = GPTDataset(indexed, 16, 64, seed=5, documents=docs["valid"])
    valid_tokens = np.concatenate([indexed.doc(int(d)) for d in docs["valid"]])
    for i in range(min(len(ds), 8)):
        assert np.isin(ds[i], valid_tokens).all()


def test_empty_split_raises(tmp_path):
    rng = np.random.RandomState(8)
    path = str(tmp_path / "corpus")
    write_indexed_dataset(path, _docs(rng, n_docs=10))
    hp = HybridParallelConfig.uniform(1, 2, global_bsz=2)
    with pytest.raises(ValueError, match="empty document subset"):
        next(gpt_data_iterator(path, hp, seq_len=8, split="test", split_weights="9,1,0"))


@pytest.mark.parametrize("weights", [[0.7, 0.2, 0.1], [1.0, 1.0], [0.5, 0.25, 0.125, 0.125],
                                     [3.0]])
def test_blending_indices_native_equal_plain_and_jax_package(weights):
    ds_idx, ds_sample = D.build_blending_indices(weights, 1000)
    py_idx, py_sample = D._build_blending_indices_py(weights, 1000)
    np.testing.assert_array_equal(ds_idx, py_idx)
    np.testing.assert_array_equal(ds_sample, py_sample)
    j_idx, j_sample = JD.build_blending_indices(weights, 1000)
    np.testing.assert_array_equal(ds_idx, j_idx)
    np.testing.assert_array_equal(ds_sample, j_sample)
    w = np.asarray(weights) / np.sum(weights)
    counts = np.bincount(ds_idx, minlength=len(w))
    np.testing.assert_allclose(counts / 1000.0, w, atol=0.01)
    for j in range(len(w)):
        np.testing.assert_array_equal(ds_sample[ds_idx == j], np.arange(int(counts[j])))


def test_blended_corpus_stream_resume(tmp_path):
    rng = np.random.RandomState(9)
    pa, pb = str(tmp_path / "a"), str(tmp_path / "b")
    write_indexed_dataset(pa, [rng.randint(0, 50, 30).tolist() for _ in range(20)])
    write_indexed_dataset(pb, [rng.randint(50, 100, 30).tolist() for _ in range(20)])
    hp = HybridParallelConfig.uniform(1, 2, global_bsz=2)
    blend = "0.75 %s 0.25 %s" % (pa, pb)
    kw = dict(seq_len=16, seed=3, n_samples=400, split_weights="1,0,0")
    it = gpt_data_iterator(blend, hp, **kw)
    batches = [next(it) for _ in range(40)]
    toks = np.concatenate([b["tokens"].numpy().ravel() for b in batches])
    assert 0.65 < float((toks < 50).mean()) < 0.85
    r5 = next(gpt_data_iterator(blend, hp, start_step=5, **kw))
    assert batches[5]["tokens"].equal(r5["tokens"])


def test_parse_blend_validation_and_spaced_paths():
    w, p = D.parse_blend("/data/my set/imgs")
    assert w == [1.0] and p == ["/data/my set/imgs"]
    assert D.parse_blend("2 /a 1 /b") == ([2.0, 1.0], ["/a", "/b"])
    with pytest.raises(ValueError, match="positive"):
        D.parse_blend("-1 /tmp/a 2 /tmp/b")
    with pytest.raises(ValueError, match="positive"):
        D.parse_blend("0 /tmp/a 0 /tmp/b")
    with pytest.raises(ValueError, match="alternate"):
        D.parse_blend("1 /tmp/a 2")


# ------------------------------------------------------------ package parity
@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """Two corpora, each written by BOTH packages from the same documents."""
    root = tmp_path_factory.mktemp("corpora")
    rng = np.random.RandomState(21)
    docs = {"a": _docs(rng, n_docs=50, vocab=300), "b": _docs(rng, n_docs=30, vocab=300)}
    out = {}
    for name, d in docs.items():
        write_indexed_dataset(str(root / ("port_" + name)), d)
        JD.write_indexed_dataset(str(root / ("jax_" + name)), d)
        out[name] = (str(root / ("port_" + name)), str(root / ("jax_" + name)))
    return out


def test_both_packages_write_the_same_corpus_bytes(corpora):
    for port, jax_ in corpora.values():
        for ext in (".bin", ".idx.npy"):
            with open(port + ext, "rb") as f, open(jax_ + ext, "rb") as g:
                assert f.read() == g.read()


@pytest.mark.parametrize("split", ["train", "valid", "test"])
@pytest.mark.parametrize("blend", [False, True], ids=["single", "blend"])
@pytest.mark.parametrize("start_step", [0, 3])
def test_both_packages_yield_bitwise_equal_batches(corpora, split, blend, start_step):
    """Same seed, split weights, blend and start step: each package reads
    its own copy of the corpus and yields the same tokens, labels and
    positions, batch for batch."""
    if blend:
        path = "0.6 %s 0.4 %s" % (corpora["a"][0], corpora["b"][0])
        jpath = "0.6 %s 0.4 %s" % (corpora["a"][1], corpora["b"][1])
    else:
        path, jpath = corpora["a"]
    kw = dict(seq_len=16, seed=11, n_samples=200, start_step=start_step, split=split,
              split_weights="80,12,8")
    ours = gpt_data_iterator(path, HybridParallelConfig.uniform(1, 2, global_bsz=4), **kw)
    theirs = JD.gpt_data_iterator(jpath, JHP.uniform(1, 2, global_bsz=4), **kw)
    for _ in range(5):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"tokens", "labels", "positions"}
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=k)
