"""``python -m galvatron_tpu_torch.cli <subcommand> [flags]``.

    serve              run the prefill/decode inference engine on one device
                       (--device cuda|cpu, default cuda): drives a synthetic
                       or replayed load through the continuous batcher and
                       reports TTFT/TPOT percentiles and tokens/s

The reference's other subcommands (train, search, profile,
profile-hardware, lint, report) come with later slices of the port.
"""

import sys


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print(__doc__)
        return 0
    cmd, argv = sys.argv[1], sys.argv[2:]
    if cmd == "serve":
        from galvatron_tpu_torch.cli.serve import main as run
    else:
        print("unknown subcommand %r\n%s" % (cmd, __doc__))
        return 2
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
