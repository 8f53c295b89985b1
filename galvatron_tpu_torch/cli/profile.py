"""Profiling entry points: ``python -m galvatron_tpu_torch.cli profile`` (the
model's per-layer time and memory tables) and ``profile-hardware`` (the
collective bandwidths, the sp tables and the overlap coefficient).

Port of ``galvatron_tpu/cli/profile.py``. Both run on ``--device`` (default
``cuda``; ``cpu`` when asked, never as a fallback). ``profile-hardware``
measures the world of the process group: ``torchrun --nproc_per_node N``
for N GPUs, one process for one.
"""

from __future__ import annotations

from galvatron_tpu_torch.cli.arguments import initialize_galvatron, model_config_from_args


def profile_model(args) -> dict:
    from galvatron_tpu_torch.profiler.model import ModelProfileArgs, ModelProfiler

    fam, cfg = model_config_from_args(args)
    pargs = ModelProfileArgs(
        profile_mode=args.profile_mode,
        profile_batch_size=args.profile_batch_size,
        profile_min_batch_size=args.profile_min_batch_size,
        profile_max_batch_size=args.profile_max_batch_size,
        batch_size_step=args.batch_size_step,
        profile_seq_length=args.profile_seq_length,
        profile_min_seq_length=args.profile_min_seq_length,
        profile_max_seq_length=args.profile_max_seq_length,
        seq_length_step=args.seq_length_step,
        layernum_min=args.layernum_min,
        layernum_max=args.layernum_max,
        max_tp_deg=args.max_tp_deg,
        mixed_precision=args.mixed_precision,
        config_dir=args.config_dir,
        profile_remat=bool(args.profile_remat),
        device=args.device,
    )
    if fam.make_profiler is not None:  # t5, swin: their layer types
        prof = fam.make_profiler(cfg, args.model_type, pargs)
    else:
        prof = ModelProfiler(cfg, model_name=args.model_type, args=pargs)
    results = prof.profile_all(write=True)
    comp = results["computation"]
    print("per-layer forward (%s mode): %s ms/sample; embedding+head+loss: %.6g ms/sample"
          % (args.profile_mode, ", ".join(str(comp["layertype_%d" % t])
                                           for t in range(prof.layer_types)),
             comp["other_time"]))
    for rec in prof.act_records:
        print("activation MB/layer/sample (%s): allocator %s, saved tensors %.3f"
              % ("remat" if rec["remat"] else "no remat",
                 "%.3f" % rec["allocator"] if rec["allocator"] is not None else "n/a (cpu)",
                 rec["saved"]))
    if "remat_recompute_frac" in comp:
        print("remat recompute fractions: %s" % comp["remat_recompute_frac"])
    results["act_records"] = prof.act_records
    results["paths"] = prof.config_paths()
    print("wrote %s" % " ".join(results["paths"].values()))
    return results


def profile_hardware(args) -> dict:
    from galvatron_tpu_torch.profiler.hardware import HardwareProfileArgs, HardwareProfiler
    from galvatron_tpu_torch.runtime import distributed

    pargs = HardwareProfileArgs(
        start_mb=args.start_mb,
        end_mb=args.end_mb,
        scale=args.scale,
        avg_or_min_or_first=args.avg_or_min_or_first,
        max_pp_deg=args.max_pp_deg,
        overlap_time_multiply=args.overlap_time_multiply,
        config_dir=args.config_dir,
    )
    with distributed.process_group(args.device) as device:
        prof = HardwareProfiler(pargs, device)
        results = prof.profile_all(write=True)
        if prof.rank == 0:
            for key, data in results.items():
                print("%s: %s" % (key, data if data else "{} (no file)"))
        results["paths"] = prof.config_paths()
        results["world_size"] = prof.ndev
    return results


def main_model(argv=None):
    args = initialize_galvatron(mode="profile", argv=argv)
    return profile_model(args)


def main_hardware(argv=None):
    args = initialize_galvatron(mode="profile_hardware", argv=argv)
    return profile_hardware(args)


if __name__ == "__main__":
    main_model()
