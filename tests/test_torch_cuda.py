"""The port's hand-written CUDA kernels on the card: the silent-corruption
sentinel's tree fold against its plain version (bitwise, every leaf width),
and the flash-attention
forward and backward against their plain versions on every route (the
route each call took is asserted: bf16 head_dim 128 with TMA-readable rows
runs "wgmma"), their argument checks,
the autograd Function against autograd of the plain forward, a serve run
whose prefills go through the forward and a train run whose steps go
through both. Every test is marked ``cuda`` and skips where there is no GPU
or no nvcc, from inside the test.

This file imports neither jax nor the reference package, so it also runs on
a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from galvatron_tpu_torch.cli import serve as S
from galvatron_tpu_torch.cli import train as T
from galvatron_tpu_torch.ops import flash_attention as TF

pytestmark = [pytest.mark.cuda]


def _chip_smoke():
    """chip_smoke.py's kernel-vs-plain check and tolerances: elementwise
    within a limit scaled by the element's own row of head_dim values."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
TOL_LSE = CS.TOL_LSE


def _need_cuda_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash kernel has no CPU or interpret mode")
    try:
        TF.find_nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))


def _close(out, ref, tol):
    return CS.judge(torch, out, ref, tol)[0] == 0


def _close_and_faults_caught(out, ref, tol):
    """`out` passes the check and each planted fault (a zeroed first or
    last tile of `ref`) fails it."""
    return _close(out, ref, tol) and not any(
        _close(wrong, ref, tol) for wrong in CS.planted_faults(ref).values())


def _rand(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def _want_route(q, backward=False):
    if q.dtype == torch.bfloat16 and q.shape[-1] == 128:
        return "wgmma"
    if q.dtype == torch.bfloat16 and not backward:
        return "mma"
    return "cuda_core"


@pytest.mark.parametrize("s,hd,padded,causal,dtype", [
    (128, 128, False, True, torch.bfloat16),
    (512, 128, True, True, torch.bfloat16),
    (256, 256, True, False, torch.bfloat16),
    (256, 128, False, False, torch.bfloat16),
    (384, 128, True, True, torch.float32),
    (576, 128, False, True, torch.bfloat16),  # S % 128 == 64: a half-empty last tile
    (576, 128, True, False, torch.bfloat16),
])
def test_flash_kernel_matches_plain_version(s, hd, padded, causal, dtype):
    """Kernel vs its plain version on the same inputs, every row, including
    padded query rows (they attend within the pad segment in both)."""
    _need_cuda_kernel()
    b, nh = 2, 4
    q, k, v = (_rand((b, s, nh, hd), 21 + i, dtype) for i in range(3))
    seg = None
    if padded:
        ids = torch.ones((b, s), dtype=torch.int32, device="cuda")
        ids[0, s - s // 4 - 5:] = 0
        seg = TF.SegmentIds(q=ids, kv=ids)
    n0 = TF.flash_attention_fwd.launches
    out, lse = TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=hd ** -0.5,
                                      segment_ids=seg)
    torch.cuda.synchronize()
    assert TF.flash_attention_fwd.launches == n0 + 1
    assert TF.flash_attention_fwd.last_route == _want_route(q)
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v, causal=causal, sm_scale=hd ** -0.5,
                                                    segment_ids=seg)
    tol = CS.TOL_FWD_BF16 if dtype == torch.bfloat16 else CS.TOL_FWD_FP32
    assert out.dtype == dtype and tuple(out.shape) == (b, s, nh, hd)
    assert _close_and_faults_caught(out, ref, tol)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


def test_flash_kernel_reads_strided_bsnh_in_place():
    """q/k/v as slices of one fused (B, S, 3, H, D) projection, as the
    model hands them over: no copies, same result as contiguous inputs."""
    _need_cuda_kernel()
    qkv = _rand((1, 256, 3, 4, 128), 5, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    out, _ = TF.flash_attention_fwd(q, k, v, causal=True, sm_scale=0.1)
    assert TF.flash_attention_fwd.last_route == "wgmma"
    ref, _ = TF.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                    causal=True, sm_scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_unaligned_bf16_rows_take_the_cuda_core_path(causal):
    """bf16 rows that are not 16-byte aligned cannot feed the tensor-core
    path's vector loads; the CUDA-core kernel takes them, same results."""
    _need_cuda_kernel()
    b, s, nh, hd = 1, 256, 4, 128
    bufs = [_rand((b, s, nh, hd + 1), 31 + i, torch.bfloat16) for i in range(3)]
    q, k, v = (t[..., 1:] for t in bufs)  # 2-byte offset, odd row stride
    assert q.data_ptr() % 16 != 0 and q.stride(-1) == 1
    ids = torch.ones((b, s), dtype=torch.int32, device="cuda")
    ids[0, 200:] = 0
    seg = TF.SegmentIds(q=ids, kv=ids)
    out, lse = TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=0.1, segment_ids=seg)
    torch.cuda.synchronize()
    assert TF.flash_attention_fwd.last_route == "cuda_core"
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v, causal=causal, sm_scale=0.1,
                                                    segment_ids=seg)
    assert _close(out, ref, CS.TOL_FWD_BF16)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("bad", ["head_dim", "seq", "dtype", "device", "gqa"])
def test_flash_kernel_refuses_what_it_does_not_take(bad):
    _need_cuda_kernel()
    q = torch.zeros(1, 128, 2, 128, device="cuda", dtype=torch.bfloat16)
    k = v = q
    if bad == "head_dim":
        q = k = v = torch.zeros(1, 128, 2, 64, device="cuda", dtype=torch.bfloat16)
    elif bad == "seq":
        q = k = v = torch.zeros(1, 100, 2, 128, device="cuda", dtype=torch.bfloat16)
    elif bad == "dtype":
        q = k = v = q.half()
    elif bad == "device":
        k = q.cpu()
    elif bad == "gqa":
        k = v = torch.zeros(1, 128, 1, 128, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TF.flash_attention_fwd(q, k, v, causal=True, sm_scale=0.1)


def test_serve_on_cuda_prefills_through_the_flash_kernel():
    _need_cuda_kernel()
    argv = [
        "--device", "cuda", "--model_type", "llama", "--set_model_config_manually", "1",
        "--hidden_size", "256", "--num_attention_heads", "2", "--ffn_hidden_size", "256",
        "--num_layers", "2", "--vocab_size", "64", "--seq_length", "256",
        "--serve_max_concurrency", "2", "--serve_page_size", "128",
        "--num_requests", "3", "--prompt_len_min", "100", "--prompt_len_max", "200",
        "--max_new_tokens", "3",
    ]
    n0 = TF.flash_attention_fwd.launches
    summary = S.main(argv)
    assert summary["requests"] == 3 and summary["shed"] == 0
    assert TF.flash_attention_fwd.launches - n0 == 2 * 3  # layers x prefills


def _bwd_case(b, s, nh, hd, dtype, padded, causal, seed=41):
    q, k, v, do = (_rand((b, s, nh, hd), seed + i, dtype) for i in range(4))
    seg = None
    if padded:
        ids = torch.ones((b, s), dtype=torch.int32, device="cuda")
        ids[0, s - s // 4 - 5:] = 0
        seg = TF.SegmentIds(q=ids, kv=ids)
    out, lse = TF.flash_attention_fwd(q, k, v, causal=causal, sm_scale=hd ** -0.5,
                                      segment_ids=seg)
    return q, k, v, do, out, lse, seg


@pytest.mark.parametrize("s,hd,padded,causal,dtype", [
    (128, 128, False, True, torch.bfloat16),
    (512, 128, True, True, torch.bfloat16),
    (256, 128, True, False, torch.bfloat16),
    (256, 256, True, True, torch.bfloat16),
    (384, 128, True, True, torch.float32),
    (576, 128, False, True, torch.bfloat16),  # S % 128 == 64: a half-empty last tile
    (576, 128, True, False, torch.bfloat16),
])
def test_flash_bwd_kernel_matches_plain_version(s, hd, padded, causal, dtype):
    """Backward kernel vs its plain version on the same inputs (the
    forward's out and lse included), every row and key."""
    _need_cuda_kernel()
    q, k, v, do, out, lse, seg = _bwd_case(2, s, 4, hd, dtype, padded, causal)
    n0 = TF.flash_attention_bwd.launches
    got = TF.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, sm_scale=hd ** -0.5,
                                 segment_ids=seg)
    torch.cuda.synchronize()
    assert TF.flash_attention_bwd.launches == n0 + 1
    assert TF.flash_attention_bwd.last_route == _want_route(q, backward=True)
    want = TF.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal,
                                            sm_scale=hd ** -0.5, segment_ids=seg)
    tol = CS.TOL_BWD_BF16 if dtype == torch.bfloat16 else CS.TOL_BWD_FP32
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        assert _close_and_faults_caught(g, w, tol), "%s: %s" % (
            name, CS.judge(torch, g, w, tol))


def test_flash_bwd_kernel_reads_and_writes_strided_bsnh_in_place():
    """q/k/v/out/do as slices of fused (B, S, n, H, D) buffers: the same
    gradients as from contiguous copies, bit for bit."""
    _need_cuda_kernel()
    qkv = _rand((1, 256, 3, 4, 128), 7, torch.bfloat16)
    od = _rand((1, 256, 2, 4, 128), 8, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out, do = od[:, :, 0], od[:, :, 1]
    _, lse = TF.flash_attention_fwd(q, k, v, causal=True, sm_scale=0.1)
    got = TF.flash_attention_bwd(q, k, v, out, lse, do, causal=True, sm_scale=0.1)
    assert TF.flash_attention_bwd.last_route == "wgmma"
    want = TF.flash_attention_bwd(*(t.contiguous() for t in (q, k, v, out)), lse,
                                  do.contiguous(), causal=True, sm_scale=0.1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_bwd_kernel_unaligned_bf16_rows_take_the_cuda_core_path():
    _need_cuda_kernel()
    b, s, nh, hd = 1, 256, 2, 128
    q, k, v, out, do = (_rand((b, s, nh, hd + 1), 61 + i, torch.bfloat16)[..., 1:]
                        for i in range(5))
    assert q.data_ptr() % 16 != 0 and q.stride(-1) == 1
    ids = torch.ones((b, s), dtype=torch.int32, device="cuda")
    ids[0, 190:] = 0
    seg = TF.SegmentIds(q=ids, kv=ids)
    _, lse = TF.flash_attention_fwd(q, k, v, causal=True, sm_scale=0.1, segment_ids=seg)
    got = TF.flash_attention_bwd(q, k, v, out, lse, do, causal=True, sm_scale=0.1,
                                 segment_ids=seg)
    torch.cuda.synchronize()
    assert TF.flash_attention_bwd.last_route == "cuda_core"
    want = TF.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True, sm_scale=0.1,
                                            segment_ids=seg)
    for g, w in zip(got, want):
        assert _close(g, w, CS.TOL_BWD_BF16)


def test_flash_kernels_at_the_train_micro_batch():
    """B=4, S=2048 (the train path's micro-batch) through the wgmma route,
    forward and backward against the plain versions."""
    _need_cuda_kernel()
    q, k, v, do, out, lse, _ = _bwd_case(4, 2048, 8, 128, torch.bfloat16, False, True, seed=91)
    assert TF.flash_attention_fwd.last_route == "wgmma"
    ref, ref_lse = TF.flash_attention_fwd_reference(q, k, v, causal=True, sm_scale=128 ** -0.5)
    assert _close_and_faults_caught(out, ref, CS.TOL_FWD_BF16)
    assert (lse - ref_lse).abs().max().item() <= TOL_LSE
    got = TF.flash_attention_bwd(q, k, v, out, lse, do, causal=True, sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert TF.flash_attention_bwd.last_route == "wgmma"
    want = TF.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True,
                                            sm_scale=128 ** -0.5)
    for g, w in zip(got, want):
        assert _close_and_faults_caught(g, w, CS.TOL_BWD_BF16)


@pytest.mark.parametrize("why", ["unaligned", "fp32", "head_dim_256"])
def test_forcing_wgmma_on_inputs_it_does_not_take_raises(why):
    """A forced route that does not take the inputs raises; it launches
    nothing and does not switch to another route."""
    _need_cuda_kernel()
    if why == "unaligned":
        q = _rand((1, 256, 2, 129), 71, torch.bfloat16)[..., 1:]
    elif why == "fp32":
        q = _rand((1, 256, 2, 128), 71, torch.float32)
    else:
        q = _rand((1, 256, 2, 256), 71, torch.bfloat16)
    _, lse = TF.flash_attention_fwd(q, q, q, causal=True, sm_scale=0.1)
    n_fwd, n_bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    routes = TF.flash_attention_fwd.last_route, TF.flash_attention_bwd.last_route
    with pytest.raises(ValueError, match="wgmma"):
        TF.flash_attention_fwd(q, q, q, causal=True, sm_scale=0.1, route="wgmma")
    with pytest.raises(ValueError, match="wgmma"):
        TF.flash_attention_bwd(q, q, q, q, lse, q, causal=True, sm_scale=0.1, route="wgmma")
    assert (TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches) == (n_fwd, n_bwd)
    assert (TF.flash_attention_fwd.last_route, TF.flash_attention_bwd.last_route) == routes


@pytest.mark.parametrize("bad", ["lse_shape", "lse_dtype", "do_dtype", "out_shape", "device"])
def test_flash_bwd_kernel_refuses_what_it_does_not_take(bad):
    _need_cuda_kernel()
    q = torch.zeros(1, 128, 2, 128, device="cuda", dtype=torch.bfloat16)
    out = do = q
    lse = torch.zeros(1, 2, 128, device="cuda")
    if bad == "lse_shape":
        lse = torch.zeros(1, 128, 2, device="cuda")
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "do_dtype":
        do = q.float()
    elif bad == "out_shape":
        out = torch.zeros(1, 128, 2, 256, device="cuda", dtype=torch.bfloat16)
    elif bad == "device":
        do = q.cpu()
    with pytest.raises(ValueError):
        TF.flash_attention_bwd(q, q, q, out, lse, do, causal=True, sm_scale=0.1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_function_on_cuda_matches_autograd_of_plain_forward(dtype):
    """Both kernels through FlashAttention.apply against autograd of the
    plain forward, on the card, at a small shape."""
    _need_cuda_kernel()
    b, s, nh, hd = 1, 256, 2, 128
    q, k, v = (_rand((b, s, nh, hd), 81 + i, dtype).requires_grad_() for i in range(3))
    do = _rand((b, s, nh, hd), 84, dtype)
    ids = torch.ones((b, s), dtype=torch.int32, device="cuda")
    ids[0, 200:] = 0
    n_fwd, n_bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    got = torch.autograd.grad(TF.FlashAttention.apply(q, k, v, True, 0.1, ids, ids), (q, k, v), do)
    torch.cuda.synchronize()
    assert (TF.flash_attention_fwd.launches - n_fwd, TF.flash_attention_bwd.launches - n_bwd) \
        == (1, 1)
    ref, _ = TF.flash_attention_fwd_reference(q.float(), k.float(), v.float(), causal=True,
                                              sm_scale=0.1, segment_ids=TF.SegmentIds(ids, ids))
    want = torch.autograd.grad(ref, (q, k, v), do.float())
    # fp32: summation order only; bf16: the kernels round p, ds and the
    # gradients to bf16 where autograd of the fp32 plain forward does not,
    # which the bf16 limit covers (tests/test_torch_kernel_check.py)
    tol = CS.TOL_BWD_FP32 if dtype == torch.float32 else CS.TOL_BWD_BF16
    for g, w in zip(got, want):
        assert _close_and_faults_caught(g, w, tol)


def test_train_on_cuda_steps_through_both_kernels():
    _need_cuda_kernel()
    argv = [
        "--device", "cuda", "--model_type", "llama", "--set_model_config_manually", "1",
        "--hidden_size", "256", "--num_attention_heads", "2", "--ffn_hidden_size", "256",
        "--num_layers", "2", "--vocab_size", "64", "--seq_length", "256",
        "--global_train_batch_size", "2", "--chunks", "2", "--train_iters", "3",
        "--checkpoint", "1", "--lr", "1e-3",
    ]
    n_fwd, n_bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
    summary = T.main(argv)
    assert len(summary["losses"]) == 3 and all(np.isfinite(summary["losses"]))
    # 3 steps x 2 micro-batches x 2 layers, each layer's forward run again
    # by the remat of the backward
    assert TF.flash_attention_fwd.launches - n_fwd == 3 * 2 * 2 * 2
    assert TF.flash_attention_bwd.launches - n_bwd == 3 * 2 * 2


def test_gpt_layout_path_on_cuda_through_one_rank_nccl_groups(tmp_path, monkeypatch):
    """A tiny GPT (head_dim 128, sequence 256) through the layout path on
    the card: ZeRO-3 on layer 0 and ZeRO-2 elsewhere, over one-rank NCCL
    groups, against the same run with every fsdp 0 — the same losses in
    fp32 compute (the CLI's config with its compute dtype replaced), and
    both kernels launched."""
    import dataclasses
    import json

    def fp32(args, resolve=T.model_config_from_args):
        fam, cfg = resolve(args)
        return fam, dataclasses.replace(cfg, compute_dtype=torch.float32)

    _need_cuda_kernel()
    base = [
        "--device", "cuda", "--model_type", "gpt", "--set_model_config_manually", "1",
        "--hidden_size", "256", "--num_attention_heads", "2", "--num_layers", "2",
        "--vocab_size", "96", "--seq_length", "256", "--global_train_batch_size", "2",
        "--chunks", "2", "--train_iters", "3", "--lr", "1e-3",
    ]
    monkeypatch.setattr(T, "model_config_from_args", fp32)
    losses = {}
    for fsdp in ("1,0", "0,0"):
        path = tmp_path / ("s%s.json" % fsdp.replace(",", ""))
        path.write_text(json.dumps({
            "pp_deg": 1, "tp_sizes_enc": "1,1", "tp_consecutive_flags": "1,1",
            "dp_types_enc": fsdp, "default_dp_type": "zero2", "checkpoint": "1,0",
            "global_bsz": 2, "chunks": 2}))
        n_fwd, n_bwd = TF.flash_attention_fwd.launches, TF.flash_attention_bwd.launches
        losses[fsdp] = T.main(base + ["--galvatron_config_path", str(path)])["losses"]
        # 3 steps x 2 micro-batches x (2 layers + 1 recomputed), 2 layers backward
        assert TF.flash_attention_fwd.launches - n_fwd == 3 * 2 * 3
        assert TF.flash_attention_bwd.launches - n_bwd == 3 * 2 * 2
    np.testing.assert_allclose(losses["1,0"], losses["0,0"], rtol=1e-5)


def test_device_placer_copies_batches_on_a_side_stream():
    """The prefetch thread's placement: pinned host memory, a copy on the
    placer's side stream, the consumer's stream waiting on its event; every
    batch arrives equal to its source, in order, while the main stream is
    busy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the placer copies to the card")
    from galvatron_tpu_torch.runtime.prefetch import DevicePlacer, PrefetchIterator, consume

    dev = torch.device("cuda", torch.cuda.current_device())
    src = [{"tokens": torch.randint(0, 32000, (8, 2048)),
            "positions": torch.arange(2048).expand(8, 2048)} for _ in range(6)]
    placer = DevicePlacer(dev)
    pf = PrefetchIterator(iter(src), depth=2, place_fn=placer)
    busy = torch.randn(4096, 4096, device=dev)
    for want in src:
        busy = busy @ busy / 64.0  # keep the consumer's stream occupied
        got = consume(next(pf))
        assert got["tokens"].device == dev and got["tokens"].is_contiguous()
        for k in want:
            assert torch.equal(got[k].cpu(), want[k])
    pf.close()
    assert placer.stream != torch.cuda.current_stream(dev)


def test_train_from_corpus_with_eval_save_and_resume_on_cuda(tmp_path):
    """The corpus path on the card at a tiny size (head_dim 128, sequence
    256: both kernels): eval launches the forward alone, the checkpoint
    round-trips and the resumed losses equal the uninterrupted run's."""
    _need_cuda_kernel()
    from galvatron_tpu_torch.data.dataset import write_indexed_dataset

    rng = np.random.RandomState(0)
    corpus = str(tmp_path / "corpus")
    write_indexed_dataset(corpus, [rng.randint(0, 64, rng.randint(100, 900)).tolist()
                                   for _ in range(200)])
    argv = [
        "--device", "cuda", "--model_type", "llama", "--set_model_config_manually", "1",
        "--hidden_size", "256", "--num_attention_heads", "2", "--ffn_hidden_size", "256",
        "--num_layers", "2", "--vocab_size", "64", "--seq_length", "256",
        "--global_train_batch_size", "2", "--chunks", "2", "--lr", "1e-3",
        "--lr_decay_style", "constant", "--data_path", corpus, "--split", "80,10,10",
        "--eval_interval", "2", "--eval_iters", "1",
    ]
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        full = T.main(argv + ["--train_iters", "4"])
        T.main(argv + ["--train_iters", "2", "--save", str(tmp_path / "ck")])
        resumed = T.main(argv + ["--train_iters", "4", "--load", str(tmp_path / "ck")])
    finally:
        torch.use_deterministic_algorithms(prev)
    assert full["eval_flash_launches"] == {"fwd": 3 * 2, "bwd": 0}  # 3 passes x 1 x 2 layers
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["test_loss"] == full["test_loss"]


# ------------------------------------------------------------ the tree fold
@pytest.mark.parametrize("dtype,n", [(torch.float32, 1_000_003), (torch.bfloat16, 77_777),
                                     (torch.float16, 4097), (torch.float64, 1023),
                                     (torch.int32, 12_345), (torch.int64, 5_431),
                                     (torch.uint8, 333), (torch.bool, 4099)])
def test_tree_fold_kernel_is_bitwise_its_plain_version(dtype, n):
    """The silent-corruption sentinel's fold kernel (csrc/tree_fold.cu)
    against its plain version on the card, one leaf of each width and kind
    at an odd length, then with an empty leaf and an fp32 leaf in one tree
    (one launch); a flipped bit changes the fold."""
    from galvatron_tpu_torch.ops import tree_fold as TFold

    _need_cuda_kernel()
    g = torch.Generator(device="cuda")
    g.manual_seed(n)
    if dtype.is_floating_point:
        x = torch.randn(n, generator=g, device="cuda").to(dtype)
    elif dtype == torch.bool:
        x = torch.rand(n, generator=g, device="cuda") > 0.5
    else:
        hi = 256 if dtype == torch.uint8 else 2**31 - 1
        x = torch.randint(0 if dtype == torch.uint8 else -hi, hi, (n,), generator=g,
                          device="cuda", dtype=dtype)
    tree = [x, torch.zeros(0, device="cuda"), torch.randn(129, generator=g, device="cuda")]
    n0 = TFold.tree_fold.launches
    fold, sumsq = TFold.tree_fold(tree)
    ref_fold, ref_sumsq = TFold.tree_fold_reference(tree)
    assert TFold.tree_fold.launches == n0 + 1
    assert int(fold) == int(ref_fold)
    assert float(sumsq) == pytest.approx(float(ref_sumsq), rel=1e-4)
    tree[2].view(torch.int32)[64] ^= 1 << 18
    assert int(TFold.tree_fold(tree)[0]) != int(fold)


def test_tree_fold_kernel_leaves_the_current_device_as_it_was():
    """Leaves on another card than the current one: the kernel launches on
    theirs and the caller's current device (torch's too) stays put."""
    from galvatron_tpu_torch.ops import tree_fold as TFold

    _need_cuda_kernel()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the leaves lie on the one that is not current")
    torch.cuda.set_device(0)
    x = torch.arange(10_001, device="cuda:1", dtype=torch.int32)
    fold, _ = TFold.tree_fold([x])
    assert torch.cuda.current_device() == 0
    assert fold.device == x.device
    assert int(fold) == int(TFold.tree_fold_reference([x])[0])
