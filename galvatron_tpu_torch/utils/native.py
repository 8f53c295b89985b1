"""Build of the port's host-side C++ helpers (the corpus index helper, the
search's DP core): ``$CXX`` (default ``g++``) at first use, into
``build/galvatron_tpu_torch/``, under a key of the source and the flags.
A failed build raises; no caller falls back to a plain version."""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "galvatron_tpu_torch")


def keyed_path(source: str, stem: str, flags: Sequence[str], build_dir: str = BUILD_DIR) -> str:
    """``<build_dir>/<stem>_<hash of source and flags>.so``."""
    h = hashlib.sha256()
    with open(source, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(build_dir, "%s_%s.so" % (stem, h.hexdigest()[:16]))


def compile_shared(source: str, so: str, flags: Sequence[str]) -> str:
    """Compile `source` into the shared library `so` unless it exists
    (written to a temporary file and renamed, so a concurrent or killed
    build never leaves a torn library). Returns `so`."""
    if os.path.exists(so):
        return so
    cxx = os.environ.get("CXX", "g++")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        try:
            proc = subprocess.run([cxx, *flags, "-o", tmp, source],
                                  capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError("cannot build %s: %s (%s)" % (source, cxx, e)) from e
        if proc.returncode != 0:
            raise RuntimeError("%s failed (%d) on %s:\n%s"
                               % (cxx, proc.returncode, source, proc.stdout + proc.stderr))
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so
