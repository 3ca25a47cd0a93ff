"""Host-core scaling curve: does e2e demux throughput
track available host cores?

The repo's north-star accounting says the single-chip e2e number is
host-I/O-bound: the matcher is ~100x faster than the host can feed it, so
e2e reads/s should scale ~linearly with host cores until the free-matcher
ceiling.  This script turns that inference into data: it runs the
dual-index e2e (product) AND the reference-architecture proxy (same native
scanner/writer forced into the reference's serial assign loop,
``demux.rs:945-977`` shape) pinned to 1..ncores host cores with `taskset`,
interleaved so a VM noise phase hits every leg, and writes
CORE_SCALING_LOCAL.json with reads/s, reads/s-per-core, and a least-squares
slope.

Run:  python scripts/core_scaling.py [n_reads] [trials]
Leg:  python scripts/core_scaling.py --leg product|proxy <data_dir> <n>
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402


def build_inputs(tmp: Path, n: int):
    bcs = bench.make_whitelist(bench.K, bench.L, seed=7)
    paths, meta = bench.write_inputs(tmp, bcs, n, "cs_")
    order = ["i1", "r1", "r2", "i2"]
    manifest = {
        "inputs": [str(paths[k]) for k in order],
        "structures": ["8B", "100T", "100T", "9B"],
        "meta": str(meta),
        "barcodes": bcs,
        "n": n,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    return manifest


def run_leg(kind: str, data_dir: Path, n: int) -> None:
    """One child-process measurement; prints reads/s on the last line."""
    import time

    m = json.loads((data_dir / "manifest.json").read_text())
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        if kind == "product":
            rps, _ = bench.run_e2e(
                tmp, m["inputs"], m["structures"], m["meta"], n, "leg",
                trials=1,
            )
        elif kind == "proxy":
            rps = bench.run_refproxy(
                tmp, m["inputs"], m["structures"], m["barcodes"], n, "leg",
                trials=1, threads=16,
            )
        elif kind == "sub_product":
            from fqtk_tpu.runtime.subsample import (
                SubsampleConfig, run_subsample,
            )

            cfg = SubsampleConfig(
                inputs=[m["inputs"][1], m["inputs"][2]],
                output=tmp / "sub", fraction=0.3, threads=8, seed=42,
            )
            t0 = time.perf_counter()
            res = run_subsample(cfg)
            rps = res.total_read / (time.perf_counter() - t0)
        else:  # sub_proxy: reference shape — serial lockstep loop, native
            # ChaCha mask drawn between chunks (generous-to-baseline, same
            # as bench_subsample_config's proxy)
            from fqtk_tpu.io import native as native_io

            rng = native_io.NativeChaChaMask(42)
            eng = native_io.NativeSubsampleEngine(
                threads=7, compression_level=5
            )
            try:
                for i, p in enumerate(m["inputs"][1:3]):
                    eng.add_input(p, tmp / f"subproxy.R{i + 1}.fq.gz")
                eng.configure(check_names=True, parallel=False)
                t0 = time.perf_counter()
                total = 0
                while True:
                    mask = rng.keep_mask(1 << 16, 0.3)
                    c, _ = eng.process_chunk(mask)
                    total += c
                    if c < len(mask):
                        break
                eng.finish()
            finally:
                eng.close()
            rps = total / (time.perf_counter() - t0)
    print(f"RPS {rps:.1f}")


def main():
    if len(sys.argv) > 1 and sys.argv[1] == "--leg":
        run_leg(sys.argv[2], Path(sys.argv[3]), int(sys.argv[4]))
        return

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    trials = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    ncores = os.cpu_count() or 1
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        build_inputs(tmp, n)

        def child(kind, cores):
            cpus = ",".join(str(i) for i in range(cores))
            cmd = [
                "taskset", "-c", cpus, sys.executable, __file__,
                "--leg", kind, str(tmp), str(n),
            ]
            out = subprocess.run(
                cmd, capture_output=True, text=True, check=True
            ).stdout
            return float(out.strip().splitlines()[-1].split()[1])

        kinds = ("product", "proxy", "sub_product", "sub_proxy")
        # page-cache warm + thread-pool shapes compiled once, untimed
        for kind in kinds:
            child(kind, ncores)

        results = {
            k: {c: 0.0 for c in range(1, ncores + 1)} for k in kinds
        }
        for t in range(trials):
            for cores in range(1, ncores + 1):
                for kind in kinds:
                    rps = child(kind, cores)
                    results[kind][cores] = max(results[kind][cores], rps)
                    print(
                        f"trial {t} {kind} cores={cores}: {rps / 1e6:.3f}M",
                        flush=True,
                    )

        report = {
            "config": "dual-index PE, 96 samples, 8B+9B, max_mm=1, delta=2; "
            "sub_* legs: PE subsample fraction 0.3 on the same R1/R2",
            "n_reads": n,
            "trials_best_of": trials,
            "host_cores": ncores,
            "note": (
                "taskset-pinned children, interleaved trials; per-core = "
                "reads/s divided by cores; slope = least-squares through "
                "the origin of reads/s vs cores (linear scaling => e2e is "
                "host-core-bound, so throughput on a bigger host tracks "
                "its core count until other limits bind)"
            ),
        }
        for kind in kinds:
            xs = sorted(results[kind])
            ys = [results[kind][c] for c in xs]
            slope = sum(c * r for c, r in zip(xs, ys)) / sum(
                c * c for c in xs
            )
            # R^2 of the through-origin fit
            mean = sum(ys) / len(ys)
            ss_res = sum((r - slope * c) ** 2 for c, r in zip(xs, ys))
            ss_tot = sum((r - mean) ** 2 for r in ys) or 1.0
            report[kind] = {
                "reads_per_sec_by_cores": {
                    str(c): round(results[kind][c], 1) for c in xs
                },
                "reads_per_sec_per_core": {
                    str(c): round(results[kind][c] / c, 1) for c in xs
                },
                "slope_reads_per_sec_per_core": round(slope, 1),
                "r2_linear_through_origin": round(1 - ss_res / ss_tot, 4),
            }
        report["product_vs_proxy_slope"] = round(
            report["product"]["slope_reads_per_sec_per_core"]
            / report["proxy"]["slope_reads_per_sec_per_core"],
            3,
        )
        report["subsample_product_vs_proxy_slope"] = round(
            report["sub_product"]["slope_reads_per_sec_per_core"]
            / report["sub_proxy"]["slope_reads_per_sec_per_core"],
            3,
        )
        out_path = REPO / "CORE_SCALING_LOCAL.json"
        out_path.write_text(json.dumps(report, indent=1) + "\n")
        print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
