"""Measure a Rust-fqtk baseline proxy on this host.

BASELINE.json asks for a locally measured 16-thread ``fqtk demux`` baseline,
but this image has no Rust toolchain.  This script measures the closest
defensible proxy instead: a C++ re-creation of the reference's OWN pipeline
architecture (``native/fqtk_io.cpp`` ``refproxy_run``; see the comment block
there), run on the same generated dual-index paired-end dataset the
benchmark uses:

- one read-ahead thread per input, bounded 1000-record chunk queues
  (fgoxide ``read_ahead(1000, 1000)``, demux.rs:928-934)
- ONE main thread: segment extraction, scalar branch-and-bound barcode
  matching with a 1M-entry memo cache (barcode_matching.rs:119-182), header
  rewriting, record formatting into pooled writers (demux.rs:945-977)
- remaining threads BGZF-compress at level 5 via libdeflate — the same
  backend the reference's ``bgzf`` crate links (Cargo.lock: bgzf ->
  libdeflater)

Known deltas, all GENEROUS to the baseline (so vs_baseline is conservative):
input decompression uses the whole-block libdeflate BGZF path (faster than
the reference's streaming zlib-ng via flate2), and reader threads number
one per input (the reference's nominal budget reserves only 1-2).

With --threads 16 (the BASELINE.json spec) on this 4-core host the extra
compressor threads just oversubscribe, exactly as 16-thread Rust fqtk would.

Writes BASELINE_MEASURED.json at the repo root; bench.py picks it up for
``vs_baseline``.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--reads", type=int, default=2_000_000)
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()

    import bench
    from fqtk_tpu.io import native as native_io

    if not native_io.available():
        print("native library unavailable", file=sys.stderr)
        return 1

    bench.N_READS = args.reads
    barcodes = bench.make_whitelist(bench.K, bench.L)

    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        paths, _meta = bench.write_inputs(tmp, barcodes, n_reads=args.reads)
        inputs = [paths["i1"], paths["r1"], paths["r2"], paths["i2"]]
        # shared proxy harness (bench.run_refproxy): reference thread budget
        # (1 main + 2 readers reserved, remainder compresses), best-of-N
        best = bench.run_refproxy(
            tmp,
            inputs,
            ["8B", "100T", "100T", "9B"],
            barcodes,
            args.reads,
            "baseline",
            trials=args.trials,
            threads=args.threads,
        )
        print(f"best: {best/1e6:.3f}M reads/s over {args.trials} trial(s)")

    # The pin is the BEST proxy ever observed (generous to the baseline):
    # this host has ~2x noisy-neighbor phases lasting tens of minutes, so a
    # re-measure in a bad window must never lower the recorded baseline.
    pin_path = REPO / "BASELINE_MEASURED.json"
    pinned_threads = args.threads
    if pin_path.exists():
        prev = json.loads(pin_path.read_text())
        if prev.get("value", 0) > best:
            print(
                f"keeping pinned best {prev['value']/1e6:.3f}M reads/s "
                f"(> this window's {best/1e6:.3f}M)"
            )
            best = prev["value"]
            # the metadata must describe the PINNED measurement, not this
            # run's flags (bench.py publishes it in baseline_note)
            pinned_threads = prev.get("threads", args.threads)
    out = {
        "metric": "rust_fqtk_demux_baseline_proxy_reads_per_sec",
        "value": round(best, 1),
        "threads": pinned_threads,
        "method": (
            "C++ re-creation of the reference pipeline architecture "
            "(read-ahead threads + single scalar-matcher main thread + "
            "libdeflate BGZF writer pool), generous-to-baseline deltas "
            "documented in scripts/measure_baseline.py; value = best of "
            "repeated measurement sessions (the host shows ~2x "
            "noisy-neighbor phases); conservative for vs_baseline"
        ),
        "config": "dual-index PE, 96 samples, 8B+9B, max_mm=1, delta=2",
        "host": "bench host",
    }
    pin_path.write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
