"""``python -m galvatron_tpu_torch.cli <subcommand> [flags]``.

    serve              run the prefill/decode inference engine under a
                       per-layer strategy on 1..N GPUs (torchrun
                       --nproc_per_node N for N > 1; --device cuda|cpu,
                       default cuda): drives a synthetic or replayed load
                       through the continuous batcher and reports TTFT/TPOT
                       percentiles and tokens/s
    train              train under a per-layer strategy on 1..N GPUs
                       (torchrun --nproc_per_node N for N > 1; --device
                       cuda|cpu, default cuda): strategy -> lint -> model
                       shards -> synthetic LM batches -> loss and gradients
                       -> clip + Adam + weight decay for --train_iters
                       steps, with a timing summary from rank 0
    profile            profile the model's per-layer time and memory on the
                       port's own layers (CUDA events and the allocator's
                       peak on --device cuda, the default) into
                       --config_dir
    profile-hardware   profile collective bandwidths, the sp tables and the
                       compute/communication overlap over NCCL (torchrun
                       --nproc_per_node N for N > 1)
    search             search the per-layer strategy over the profiles in
                       --config_dir for GALVATRON_WORLD_SIZE devices
                       (default 8; CPU only) and write its JSON, which
                       `train --galvatron_config_path` runs
    lint               static analysis before a job is spent: strategy
                       JSONs (GLS0xx/1xx: structure, pipeline engines,
                       model divisibility, the memory estimate against
                       --memory_budget_gb, --serve feasibility) and
                       checkpoint directories (--ckpt DIR, GLS21x; --deep
                       restores each step and recomputes its integrity
                       folds on --device); exit 0 clean, 1 errors, 2 usage
    report             offline analysis of a --telemetry JSONL (train or
                       serve): steady step time, MFU, predicted vs measured
                       per layer run, lifecycle timeline, serving and
                       integrity rollups (--json for the dict); exit 0
                       clean, 1 schema violations, 2 usage or IO failure

The loop:
    python -m galvatron_tpu_torch.cli profile-hardware
    python -m galvatron_tpu_torch.cli profile --model_type llama ...
    GALVATRON_WORLD_SIZE=N python -m galvatron_tpu_torch.cli search ... --output_config_path s.json
    python -m galvatron_tpu_torch.cli lint s.json --world_size N --memory_budget_gb 80
    python -m galvatron_tpu_torch.cli train --galvatron_config_path s.json --telemetry run.jsonl ...
    python -m galvatron_tpu_torch.cli report run.jsonl
"""

import sys


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "serve":
        from galvatron_tpu_torch.cli.serve import main as run
    elif cmd == "train":
        from galvatron_tpu_torch.cli.train import main as run
    elif cmd == "search":
        from galvatron_tpu_torch.cli.search import main as run
    elif cmd == "profile":
        from galvatron_tpu_torch.cli.profile import main_model as run
    elif cmd == "profile-hardware":
        from galvatron_tpu_torch.cli.profile import main_hardware as run
    elif cmd == "lint":
        from galvatron_tpu_torch.cli.lint import run as run_lint

        return run_lint(argv)
    elif cmd == "report":
        from galvatron_tpu_torch.obs.report import run as run_report

        return run_report(argv)
    else:
        print("unknown subcommand %r\n%s" % (cmd, __doc__))
        return 2
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
