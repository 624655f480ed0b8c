"""Comparison table vs external compressors (reference parity: the harness
prints zlib/LZ4/zstd rows, test/main.cpp:130-251, 944-1118, and README.md
publishes them at README.md:62-90).

Produces COMPARISON.md + COMPARISON.json at the repo root:
  - CT codec per-file ratios from real round-trip-verified containers
    (ratio is measurement-method-independent);
  - external rows (zlib/bz2/xz — the libs this image ships) with host
    CPU MB/s, like the reference's baseline tables;
  - the reference's own published ratios for context (BASELINE.md).

Run:  python -m cpprcoder_tpu.bench.compare  [--codecs rcq adaptive_range]
"""

from __future__ import annotations

import json


CT_DEFAULT = ("rcx", "rcq", "adaptive_range", "static_range", "rans",
              "huffman", "slz4")
PIPELINES = {"bwt_pipeline": ["blocksort", "mtf1", "rle0", "adaptive_range"]}


def build(ct_codecs=CT_DEFAULT, pipelines=PIPELINES, files=None) -> dict:
    from cpprcoder_tpu.bench.harness import (
        CANTERBURY,
        REF_RATIOS,
        external_names,
        load,
        run_external,
    )
    from cpprcoder_tpu.codecs import get_codec
    from cpprcoder_tpu.codecs.pipeline import pipeline_decode, pipeline_encode

    files = files or CANTERBURY
    out = {"files": files, "ct": {}, "external": {}, "reference": REF_RATIOS}
    for name in ct_codecs:
        codec = get_codec(name)
        rows = {}
        for f in files:
            data = load(f)
            blob = codec.encode(data)
            ok = codec.decode(blob) == data
            rows[f] = {"ratio": round(len(blob) / len(data), 5),
                       "roundtrip_ok": bool(ok)}
        out["ct"][name] = rows
    for pname, stages in (pipelines or {}).items():
        rows = {}
        for f in files:
            data = load(f)
            blob = pipeline_encode(data, stages=stages)
            ok = pipeline_decode(blob) == data
            rows[f] = {"ratio": round(len(blob) / len(data), 5),
                       "roundtrip_ok": bool(ok)}
        out["ct"][pname] = rows
    for ext in external_names():
        agg = run_external(ext, files=files)
        out["external"][ext] = {
            r["file"]: {"ratio": round(r["ratio"], 5),
                        "enc_MBps": round(r["enc_MBps"], 1),
                        "dec_MBps": round(r["dec_MBps"], 1),
                        "roundtrip_ok": r["roundtrip_ok"]}
            for r in agg["files"]}
    return out


def to_markdown(d: dict) -> str:
    files = d["files"]
    cols = (list(d["ct"]) + [f"{e} (host)" for e in d["external"]]
            + ["ref adaptive", "ref zlib"])
    lines = ["# Ratio comparison (Canterbury corpus)", "",
             "Ratio = compressed/original (smaller is better). CT rows are "
             "round-trip-verified containers; external rows are this host's "
             "zlib/bz2/xz; reference columns are the upstream README's "
             "published numbers (BASELINE.md).", "",
             "| File | " + " | ".join(cols) + " |",
             "|" + "---|" * (len(cols) + 1)]
    ref = d["reference"]
    for f in files:
        row = [f]
        for c in d["ct"].values():
            row.append(f'{c[f]["ratio"]:.4f}' if c[f]["roundtrip_ok"]
                       else "FAIL")
        for e in d["external"].values():
            row.append(f'{e[f]["ratio"]:.4f}')
        row.append(str(ref.get("adaptive_range", {}).get(f, "-")))
        row.append(str(ref.get("zlib", {}).get(f, "-")))
        lines.append("| " + " | ".join(row) + " |")
    lines += ["", "External host throughput (MB/s, this machine):", ""]
    lines.append("| Codec | enc MB/s (agg) | dec MB/s (agg) |")
    lines.append("|---|---|---|")
    for e, rows in d["external"].items():
        tot = sum_enc = sum_dec = 0.0
        for f in files:
            n = 1.0
            tot += n
            sum_enc += n / rows[f]["enc_MBps"]
            sum_dec += n / rows[f]["dec_MBps"]
        lines.append(f"| {e} | {tot / sum_enc:.1f} | {tot / sum_dec:.1f} |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if "--cpu" in argv:
        # Ratios are measurement-independent and containers are
        # backend-identical (tests/test_registry.py), so the table can be
        # built on CPU JAX without occupying the accelerator.
        import jax

        jax.config.update("jax_platforms", "cpu")
    from cpprcoder_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    d = build()
    with open("COMPARISON.json", "w") as f:
        json.dump(d, f, indent=1)
    with open("COMPARISON.md", "w") as f:
        f.write(to_markdown(d))
    print("wrote COMPARISON.md / COMPARISON.json")


if __name__ == "__main__":
    main()
