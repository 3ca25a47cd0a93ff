"""Wall/CPU accounting for one e2e demux config.

Reproduces a bench config (default: the variable-length PE one sitting at
0.773 of its host ceiling) and decomposes the gap:

    cores * wall = counted_io_cpu (parse+gate+route+compress)
                 + uncounted_cpu  (matcher, python driver, engine misc)
                 + idle           (drain bubbles, serialization)

Run: python scripts/profile_e2e.py [varlen|dualindex|single] [n_reads]
"""

import gzip
import os
import resource
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def make_barcodes(n, length, seed=3):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out, seen = [], set()
    while len(out) < n:
        bc = bytes(rng.choice(bases, size=length)).decode()
        if bc not in seen:
            seen.add(bc)
            out.append(bc)
    return out


def _open_writer(path):
    """BGZF when the native library is present (matches bench.py inputs —
    the reference's documented ``... | bgzip -c`` workflow), gzip fallback."""
    from fqtk_tpu.io import native as native_io

    if native_io.available():
        return native_io.NativeBgzfWriter(path, 1, threads=3)
    return gzip.open(path, "wb", compresslevel=1)


def write_input(tmp, barcodes, n_reads, name, var_template):
    rng = np.random.default_rng(13)
    choices = rng.integers(0, len(barcodes), size=n_reads)
    path = tmp / f"{name}.fq.gz"
    tmpl_full = ("ACGT" * 40).encode()
    with _open_writer(path) as fh:
        chunk = 100_000
        for lo in range(0, n_reads, chunk):
            hi = min(lo + chunk, n_reads)
            parts = []
            for i in range(lo, hi):
                bc = barcodes[choices[i]].encode()
                tl = 100 if not var_template else 60 + (i % 81)
                seq = bc + tmpl_full[:tl]
                parts.append(
                    b"@inst:1:AB:1:2:%d:3 1:N:0:0\n%s\n+\n%s\n"
                    % (i, seq, b"I" * len(seq))
                )
            fh.write(b"".join(parts))
    return path


def main():
    config = sys.argv[1] if len(sys.argv) > 1 else "varlen"
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
    from fqtk_tpu.runtime.demux import DemuxConfig, run_demux

    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        barcodes = make_barcodes(96, 17)
        if config == "varlen":
            bcs1 = [b[:8] for b in barcodes]
            bcs2 = [b[8:] for b in barcodes]
            i1 = write_input(tmp, bcs1, n_reads, "v1", var_template=True)
            i2 = write_input(tmp, bcs2, n_reads, "v2", var_template=True)
            inputs, structures = [i1, i2], ["8B+T", "9B+T"]
        elif config == "dualindex":
            bcs1 = [b[:8] for b in barcodes]
            bcs2 = [b[8:] for b in barcodes]
            i1 = write_input(tmp, bcs1, n_reads, "d1", var_template=False)
            i2 = write_input(tmp, bcs2, n_reads, "d2", var_template=False)
            inputs, structures = [i1, i2], ["8B+T", "9B+T"]
        elif config == "headline":
            # the bench headline shape: I1 + R1 + R2 + I2 (8B, 100T, 100T, 9B)
            def write_plain(tmp, seqs, name):
                path = tmp / f"{name}.fq.gz"
                with _open_writer(path) as fh:
                    chunk = 100_000
                    for lo in range(0, n_reads, chunk):
                        hi = min(lo + chunk, n_reads)
                        fh.write(
                            b"".join(
                                b"@inst:1:AB:1:2:%d:3 1:N:0:0\n%s\n+\n%s\n"
                                % (i, seqs[i], b"I" * len(seqs[i]))
                                for i in range(lo, hi)
                            )
                        )
                return path

            rng = np.random.default_rng(13)
            choices = rng.integers(0, len(barcodes), size=n_reads)
            tmpl = ("ACGT" * 25).encode()
            i1 = write_plain(
                tmp, [barcodes[c][:8].encode() for c in choices], "h_i1"
            )
            i2 = write_plain(
                tmp, [barcodes[c][8:].encode() for c in choices], "h_i2"
            )
            r1 = write_plain(tmp, [tmpl] * n_reads, "h_r1")
            r2 = write_plain(tmp, [tmpl] * n_reads, "h_r2")
            inputs = [i1, r1, r2, i2]
            structures = ["8B", "100T", "100T", "9B"]
        else:
            i1 = write_input(tmp, barcodes, n_reads, "s1", var_template=False)
            inputs, structures = [i1], ["17B+T"]
        meta = tmp / "meta.tsv"
        meta.write_text(
            "sample_id\tbarcode\n"
            + "".join(f"S{i:02d}\t{b}\n" for i, b in enumerate(barcodes))
        )

        for trial in range(3):
            out = tmp / f"out{trial}"
            cfg = DemuxConfig(
                inputs=inputs,
                read_structures=structures,
                sample_metadata=meta,
                output=out,
                engine="auto",
            )
            r0 = resource.getrusage(resource.RUSAGE_SELF)
            t0 = time.perf_counter()
            res = run_demux(cfg)
            wall = time.perf_counter() - t0
            r1 = resource.getrusage(resource.RUSAGE_SELF)
            cpu = (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime)
            t = res.timings
            io_keys = ("native_parse", "native_gate_pack", "native_route",
                       "native_compress")
            io_core_s = sum(t.get(k, 0.0) for k in io_keys)
            cores = os.cpu_count() or 1
            budget = cores * wall
            idle = budget - cpu
            uncounted = cpu - io_core_s
            print(
                f"trial {trial}: wall={wall:.3f}s rps={n_reads/wall:,.0f} "
                f"frac_of_ceiling={(n_reads/wall)/(n_reads*cores/io_core_s):.3f}"
            )
            print(
                f"  cores*wall={budget:.2f} cpu={cpu:.2f} "
                f"counted_io={io_core_s:.2f} uncounted_cpu={uncounted:.2f} "
                f"idle={idle:.2f}"
            )
            print(
                "  stages:",
                {k: round(v, 3) for k, v in sorted(t.items())
                 if k.startswith("native") and not k.endswith("bytes")},
            )


if __name__ == "__main__":
    main()
