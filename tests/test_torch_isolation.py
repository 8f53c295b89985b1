"""The port stands alone: no module of galvatron_tpu_torch, and not
chip_smoke.py, imports jax or the reference package; importing every module
of the port leaves jax unloaded; and a CPU tensor never builds a kernel."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import galvatron_tpu_torch
from galvatron_tpu_torch.ops import flash_attention as TF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(galvatron_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "galvatron_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    assert os.path.exists(path)
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, "%s imports %s" % (os.path.relpath(path, REPO), sorted(bad))


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import pkgutil, sys, galvatron_tpu_torch\n"
        "for m in pkgutil.walk_packages(galvatron_tpu_torch.__path__, 'galvatron_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith('galvatron_tpu_torch')]))\n"
        % (FORBIDDEN,)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_cpu_tensors_never_build_or_launch(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a CPU tensor triggered a kernel build")

    monkeypatch.setattr(TF, "build", no_build)
    monkeypatch.setattr(TF._KernelLibrary, "get", no_build)
    q = torch.randn(1, 128, 2, 128)
    ids = torch.ones(1, 128, dtype=torch.int32)
    n0 = TF.flash_attention_fwd.launches
    out, lse = TF.flash_attention_fwd(q, q, q, causal=True, sm_scale=0.1,
                                      segment_ids=TF.SegmentIds(ids, ids))
    assert TF.flash_attention_fwd.launches == n0
    ref, ref_lse = TF.flash_attention_fwd_reference(q, q, q, causal=True, sm_scale=0.1,
                                                    segment_ids=TF.SegmentIds(ids, ids))
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(TF.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-cuda"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(TF.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        TF.find_nvcc()


def test_build_output_lives_under_the_ignored_build_dir():
    path = TF.library_path()
    assert path.startswith(os.path.join(REPO, "build", "galvatron_tpu_torch") + os.sep)
    assert os.path.basename(path).startswith("flash_attn_fwd_")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()
