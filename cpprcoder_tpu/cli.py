"""Command-line interface.

    python -m cpprcoder_tpu.cli compress   -c rans  in.bin out.ct
    python -m cpprcoder_tpu.cli decompress -c rans  out.ct roundtrip.bin
    python -m cpprcoder_tpu.cli bench      -c adaptive_range [files...]
    python -m cpprcoder_tpu.cli list
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="cpprcoder_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress")
    pc.add_argument("-c", "--codec", default="rans")
    pc.add_argument("--backend", default=None, choices=[None, "jax", "ref", "native"])
    pc.add_argument("--stages", nargs="*", default=None,
                    help="pipeline stages (overrides --codec)")
    pc.add_argument("infile")
    pc.add_argument("outfile")

    pd = sub.add_parser("decompress")
    pd.add_argument("-c", "--codec", default="rans")
    pd.add_argument("--backend", default=None, choices=[None, "jax", "ref", "native"])
    pd.add_argument("--stages", action="store_true",
                    help="input is a CT-PIPE container")
    pd.add_argument("infile")
    pd.add_argument("outfile")

    pb = sub.add_parser("bench")
    pb.add_argument("-c", "--codecs", nargs="*", default=["adaptive_range"])
    pb.add_argument("--files", nargs="*", default=None)
    pb.add_argument("--json", action="store_true")

    sub.add_parser("list")

    for sp in (pc, pd):
        sp.add_argument("--profile", action="store_true",
                        help="print per-phase counters to stderr")
    # shadow verification hooks Codec.encode only, so the flag belongs to
    # compress alone (on decompress it would be a silent no-op)
    pc.add_argument("--shadow", action="store_true",
                    help="verify encode with an independent shadow "
                         "decode (divergence detection)")

    args = p.parse_args(argv)

    if args.cmd == "list":
        from cpprcoder_tpu.codecs import list_codecs

        print("\n".join(list_codecs()))
        return 0

    if args.cmd == "bench":
        from cpprcoder_tpu.bench import harness

        harness.main((args.codecs or []) +
                     (["--json"] if args.json else []) +
                     (["--files"] + args.files if args.files else []))
        return 0

    data = open(args.infile, "rb").read()
    if args.profile:
        from cpprcoder_tpu.utils import profiling

        profiling.enable()
    if getattr(args, "shadow", False):
        from cpprcoder_tpu import debug

        debug.set_shadow(True)
    t0 = time.perf_counter()
    if args.cmd == "compress":
        if args.stages:
            from cpprcoder_tpu.codecs.pipeline import pipeline_encode

            out = pipeline_encode(data, stages=args.stages,
                                  backend=args.backend)
        else:
            from cpprcoder_tpu.codecs import compress

            out = compress(data, codec=args.codec, backend=args.backend)
        msg = f"{len(data)} -> {len(out)} ({len(out)/max(len(data),1):.4f})"
    else:
        if args.stages:
            from cpprcoder_tpu.codecs.pipeline import pipeline_decode

            out = pipeline_decode(data, backend=args.backend)
        else:
            from cpprcoder_tpu.codecs import decompress

            out = decompress(data, codec=args.codec, backend=args.backend)
        msg = f"{len(data)} -> {len(out)}"
    open(args.outfile, "wb").write(out)
    print(f"{msg} in {time.perf_counter()-t0:.2f}s", file=sys.stderr)
    if args.profile:
        from cpprcoder_tpu.utils import profiling

        print(profiling.format_report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
