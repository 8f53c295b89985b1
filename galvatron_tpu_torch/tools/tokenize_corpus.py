"""Offline corpus tokenizer: raw text -> the indexed dataset ``--data_path``
reads (``<prefix>.bin`` + ``<prefix>.idx.npy``).

Port of ``galvatron_tpu/tools/tokenize_corpus.py``, writing through
``data.dataset.write_indexed_dataset`` (documents streamed to a temporary
``.bin``, any stale index removed first, so a failed rerun never pairs an
old index with a new or partial ``.bin``).

Tokenizers:
  - ``bytes``       UTF-8 byte-level, vocab 256 (257 with --append-eod: id
                    256 is EOD). No dependencies, deterministic.
  - anything else   ``transformers.AutoTokenizer.from_pretrained`` of a
                    local directory (a hub name needs network). Without
                    ``transformers`` installed this raises; it never falls
                    back to bytes.

Document segmentation (``--doc-sep``):
  - ``line``        one document per non-empty input line (default)
  - ``blank-line``  documents separated by blank lines
  - ``file``        each input file is one document

CLI:
  python -m galvatron_tpu_torch.tools.tokenize_corpus \\
      --input corpus_a.txt corpus_b.txt --output /data/corpus \\
      --tokenizer bytes --append-eod

The prefix feeds ``--data_path /data/corpus``, or a weighted blend
``--data_path "0.7 /data/a 0.3 /data/b"``.
"""

from __future__ import annotations

import argparse
from typing import Iterator, List, Sequence


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255, EOD = 256."""

    vocab_size = 256
    eod_id = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    """transformers.AutoTokenizer adapter (EOD = its eos token, else its pad
    token)."""

    def __init__(self, name_or_path: str):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:
            raise ImportError(
                "tokenizer %r needs the transformers package, which is not installed here: "
                "install it, or use --tokenizer bytes" % name_or_path) from e
        self.tok = AutoTokenizer.from_pretrained(name_or_path)
        self.vocab_size = len(self.tok)
        self.eod_id = self.tok.eos_token_id
        if self.eod_id is None:
            self.eod_id = self.tok.pad_token_id

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids))


def get_tokenizer(name: str):
    return ByteTokenizer() if name == "bytes" else HFTokenizer(name)


def iter_documents(paths: Sequence[str], doc_sep: str) -> Iterator[str]:
    """Document texts from the input files under the segmentation mode."""
    for path in paths:
        with open(path, encoding="utf-8") as f:
            if doc_sep == "file":
                text = f.read().strip()
                if text:
                    yield text
            elif doc_sep == "line":
                for line in f:
                    line = line.strip()
                    if line:
                        yield line
            elif doc_sep == "blank-line":
                buf: List[str] = []
                for line in f:
                    if line.strip():
                        buf.append(line.rstrip("\n"))
                    elif buf:
                        yield "\n".join(buf)
                        buf = []
                if buf:
                    yield "\n".join(buf)
            else:
                raise ValueError("unknown --doc-sep %r" % doc_sep)


def tokenize_corpus(inputs: Sequence[str], output_prefix: str, tokenizer="bytes",
                    doc_sep: str = "line", append_eod: bool = False) -> dict:
    """Tokenize text files into <output_prefix>.bin/.idx.npy; returns
    {n_docs, n_tokens, vocab_size} (vocab_size counts the EOD id where
    --append-eod grows the table past the tokenizer's own, as the byte
    tokenizer's)."""
    from galvatron_tpu_torch.data.dataset import write_indexed_dataset

    tok = get_tokenizer(tokenizer) if isinstance(tokenizer, str) else tokenizer
    if append_eod and tok.eod_id is None:
        raise ValueError("--append-eod requested but the tokenizer has no EOD id (no eos or "
                         "pad token); pick another tokenizer or drop the flag")
    n_tokens = [0]

    def documents():
        for text in iter_documents(inputs, doc_sep):
            ids = tok.encode(text)
            if not ids:
                continue
            if append_eod:
                ids = list(ids) + [tok.eod_id]
            n_tokens[0] += len(ids)
            yield ids
        if not n_tokens[0]:
            raise ValueError("no non-empty documents found in %r" % list(inputs))

    n_docs = write_indexed_dataset(output_prefix, documents())
    vocab = max(tok.vocab_size, (tok.eod_id + 1) if append_eod else 0)
    return {"n_docs": n_docs, "n_tokens": n_tokens[0], "vocab_size": vocab}


def main(argv=None):
    p = argparse.ArgumentParser("galvatron_tpu_torch corpus tokenizer",
                                description="raw text -> <prefix>.bin/.idx.npy for --data_path")
    p.add_argument("--input", nargs="+", required=True, help="input text files")
    p.add_argument("--output", required=True, help="output dataset prefix")
    p.add_argument("--tokenizer", default="bytes",
                   help="'bytes' or a transformers AutoTokenizer name/path")
    p.add_argument("--doc-sep", default="line", choices=("line", "blank-line", "file"))
    p.add_argument("--append-eod", action="store_true",
                   help="append the tokenizer's EOD id to every document")
    a = p.parse_args(argv)
    stats = tokenize_corpus(a.input, a.output, a.tokenizer, a.doc_sep, a.append_eod)
    print("wrote %s.bin/.idx.npy: %d docs, %d tokens (vocab %d) — train with --data_path %s "
          "and --vocab_size >= %d" % (a.output, stats["n_docs"], stats["n_tokens"],
                                      stats["vocab_size"], a.output, stats["vocab_size"]))
    return stats


if __name__ == "__main__":
    main()
