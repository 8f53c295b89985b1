"""``python -m galvatron_tpu_torch.cli <subcommand> [flags]``.

    serve              run the prefill/decode inference engine on one device
                       (--device cuda|cpu, default cuda): drives a synthetic
                       or replayed load through the continuous batcher and
                       reports TTFT/TPOT percentiles and tokens/s
    train              train under a per-layer strategy on 1..N GPUs
                       (torchrun --nproc_per_node N for N > 1; --device
                       cuda|cpu, default cuda): strategy -> lint -> model
                       shards -> synthetic LM batches -> loss and gradients
                       -> clip + Adam + weight decay for --train_iters
                       steps, with a timing summary from rank 0

The reference's other subcommands (search, profile, profile-hardware, lint,
report) come with later slices of the port.
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
    else:
        print("unknown subcommand %r\n%s" % (cmd, __doc__))
        return 2
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
