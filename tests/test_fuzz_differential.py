"""Randomized differential testing: the native engine (C++ I/O + device
matcher) must produce byte-identical decompressed outputs to the pure-Python
reference path across randomized scenarios (structures, IUPAC barcodes,
no-calls, short reads, multiple inputs, all output types)."""

import gzip
import random

import pytest

from fqtk_tpu.runtime.demux import DemuxConfig, run_demux

BASES = "ACGT"
IUPAC = "ACGTMRWSYKVHDBN"


def _random_scenario(rng: random.Random, tmp_path, scenario_id: int):
    n_inputs = rng.choice([1, 2, 4])
    n_samples = rng.choice([2, 7, 24])
    n_reads = rng.randint(30, 120)

    # structures: each input gets barcode and/or template segments
    structures = []
    bc_total = 0
    for i in range(n_inputs):
        segs = []
        r = rng.random()
        if r < 0.6 or n_inputs == 1:
            blen = rng.randint(4, 10)
            segs.append(f"{blen}B")
            bc_total += blen
        if rng.random() < 0.4:
            segs.append(f"{rng.randint(2, 6)}M")
        if rng.random() < 0.3:
            segs.append(f"{rng.randint(1, 5)}S")
        if rng.random() < 0.5 and rng.random() < 0.5:
            segs.append(f"{rng.randint(3, 8)}C")
        segs.append("+T" if rng.random() < 0.5 else f"{rng.randint(5, 30)}T")
        structures.append("".join(segs))
    if bc_total == 0:
        structures[0] = "6B" + structures[0]
        bc_total = 6

    # unique same-length barcodes, occasionally IUPAC
    alphabet = IUPAC if rng.random() < 0.3 else BASES + "N"
    barcodes = set()
    while len(barcodes) < n_samples:
        barcodes.add("".join(rng.choice(alphabet) for _ in range(bc_total)))
    barcodes = sorted(barcodes)
    meta = tmp_path / f"meta{scenario_id}.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"s{i}\t{b}\n" for i, b in enumerate(barcodes))
    )

    # reads: mostly near-misses of real barcodes + random + some too-short
    def min_len(structure):
        total, num = 0, ""
        for ch in structure:
            if ch.isdigit():
                num += ch
            elif ch == "+":
                num = "1"
            else:
                total += int(num)
                num = ""
        return total

    inputs = []
    # 'X' and '-' encode to IUPAC mask 0: spec-level wildcards that never
    # mismatch any expected base (reference bitenc.rs:441 with a zero
    # observed nibble) — covers the matchers' wildcard/full-scan paths
    read_alpha = BASES + "N" + "acgtn" + "RY" + "X-"
    # clustered scenario class: duplicate-heavy reads drawn from a small
    # pool (the single-cell shape that engages the window-dedup front-end,
    # runtime/demux.py _wrap_window_dedup)
    clustered = rng.random() < 0.25
    for i in range(n_inputs):
        ml = min_len(structures[i])
        pool = [
            "".join(rng.choice(read_alpha) for _ in range(ml + rng.randint(0, 8)))
            for _ in range(rng.randint(2, max(3, n_reads // 8)))
        ]
        lines = []
        for r in range(n_reads):
            if rng.random() < 0.05:
                seq = "".join(rng.choice(BASES) for _ in range(max(0, ml - 1)))
            elif clustered and rng.random() < 0.9:
                seq = rng.choice(pool)
            else:
                seq = "".join(
                    rng.choice(read_alpha) for _ in range(ml + rng.randint(0, 8))
                )
            comment = rng.choice(["", " 1:N:0:0", " 1:Y:0:AACC", " x:y"])
            lines.append(f"@r_{r}{comment}\n{seq}\n+\n{'I' * len(seq)}\n")
        p = tmp_path / f"in{scenario_id}_{i}.fq"
        p.write_text("".join(lines))
        inputs.append(p)

    return inputs, structures, meta


@pytest.mark.parametrize("seed", [11, 22, 33, 44, 55, 66, 77, 88, 99, 110, 217])
def test_native_matches_python_fuzz(tmp_path, seed):
    rng = random.Random(seed)
    inputs, structures, meta = _random_scenario(rng, tmp_path, seed)
    max_mm = rng.choice([0, 1, 2])
    delta = rng.choice([0, 1, 2])
    batch = rng.choice([5, 64])
    results = {}
    for engine in ("native", "numpy"):
        out = tmp_path / f"out_{engine}_{seed}"
        cfg = DemuxConfig(
            inputs=inputs,
            read_structures=structures,
            sample_metadata=meta,
            output=out,
            output_types=["T", "B", "M", "C"],
            max_mismatches=max_mm,
            min_mismatch_delta=delta,
            skip_reasons=["too-few-bases"],
            batch_size=batch,
            engine=engine,
        )
        results[engine] = run_demux(cfg)

    assert (
        results["native"].skip_counts == results["numpy"].skip_counts
    ), "skip counts differ"
    out_n = tmp_path / f"out_native_{seed}"
    out_p = tmp_path / f"out_numpy_{seed}"
    files_n = sorted(p.name for p in out_n.glob("*.fq.gz"))
    files_p = sorted(p.name for p in out_p.glob("*.fq.gz"))
    assert files_n == files_p
    for name in files_n:
        a = gzip.open(out_n / name).read()
        b = gzip.open(out_p / name).read()
        assert a == b, f"{name} differs (seed={seed})"
    assert (out_n / "demux-metrics.txt").read_text() == (
        out_p / "demux-metrics.txt"
    ).read_text()


@pytest.mark.parametrize("seed", [7, 17, 27])
def test_subsample_native_matches_python_fuzz(tmp_path, seed):
    """Randomized subsample: native and Python paths byte-identical."""
    from fqtk_tpu.runtime.subsample import SubsampleConfig, run_subsample

    rng = random.Random(seed)
    n_inputs = rng.choice([1, 2, 3])
    n_reads = rng.randint(10, 400)
    fraction = rng.choice([0.0, 0.2, 0.5, 0.9, 1.0])
    inputs = []
    for i in range(n_inputs):
        lines = []
        for r in range(n_reads):
            seq = "".join(rng.choice(BASES) for _ in range(rng.randint(1, 60)))
            suffix = rng.choice(["", f"/{i % 2 + 1}", " comment here"])
            lines.append(f"@rd_{r}{suffix}\n{seq}\n+\n{'#' * len(seq)}\n")
        p = tmp_path / f"ss{seed}_{i}.fq"
        p.write_text("".join(lines))
        inputs.append(p)
    outs = {}
    for flavor, use_native in (("nat", True), ("py", False)):
        cfg = SubsampleConfig(
            inputs=inputs,
            output=tmp_path / f"ss_out_{flavor}_{seed}",
            fraction=fraction,
            seed=seed * 31 + 1,
        )
        res = run_subsample(cfg, use_native=use_native)
        outs[flavor] = res
    assert outs["nat"].total_read == outs["py"].total_read == n_reads
    assert outs["nat"].total_kept == outs["py"].total_kept
    for i in range(n_inputs):
        a = gzip.open(tmp_path / f"ss_out_nat_{seed}.R{i + 1}.fq.gz").read()
        b = gzip.open(tmp_path / f"ss_out_py_{seed}.R{i + 1}.fq.gz").read()
        assert a == b


@pytest.mark.parametrize("seed", [301, 302, 303, 304, 305])
def test_native_matches_python_fuzz_extended(tmp_path, seed):
    """Extended differential fuzz over the round-2 engine surface: BGZF
    inputs (block-parallel decode-ahead), the multi-device mesh (batch
    divisible by the 8 fake devices), and N-storm reads (mass host-side
    exceptional resolution on the 2-bit path)."""
    from fqtk_tpu.io import native as native_io

    rng = random.Random(seed)
    inputs, structures, meta = _random_scenario(rng, tmp_path, seed)

    if seed % 2:  # N-storm: most reads carry multiple no-calls
        for p in inputs:
            lines = p.read_text().splitlines()
            for i in range(1, len(lines), 4):
                s = list(lines[i])
                for _ in range(max(1, len(s) // 2)):
                    if s:
                        s[rng.randrange(len(s))] = "N"
                lines[i] = "".join(s)
                lines[i + 2] = "I" * len(s)
            p.write_text("\n".join(lines) + "\n")

    if native_io.available():
        # mix input formats within one run: BGZF (decode-ahead path),
        # streaming gzip, and plain — the auto-detect must handle all
        mixed_inputs = []
        for j, p in enumerate(inputs):
            if j % 3 == 0:
                q = p.with_suffix(".fq.gz")
                w = native_io.NativeBgzfWriter(q, 1, threads=2)
                w.write(p.read_bytes())
                w.close()
                mixed_inputs.append(q)
            elif j % 3 == 1:
                q = p.with_suffix(".gzip.fq.gz")
                with gzip.open(q, "wb", compresslevel=1) as fh:
                    fh.write(p.read_bytes())
                mixed_inputs.append(q)
            else:
                mixed_inputs.append(p)
        inputs = mixed_inputs

    max_mm = rng.choice([0, 1])
    results = {}
    for engine, devices in (("native", 8), ("numpy", 1)):
        out = tmp_path / f"out_{engine}_{seed}"
        cfg = DemuxConfig(
            inputs=inputs,
            read_structures=structures,
            sample_metadata=meta,
            output=out,
            output_types=["T", "B", "M", "C"],
            max_mismatches=max_mm,
            min_mismatch_delta=1,
            skip_reasons=["too-few-bases"],
            batch_size=16,  # divisible by the 8 fake devices -> mesh engages
            engine=engine,
            devices=devices,
        )
        results[engine] = run_demux(cfg)

    assert results["native"].skip_counts == results["numpy"].skip_counts
    out_n = tmp_path / f"out_native_{seed}"
    out_p = tmp_path / f"out_numpy_{seed}"
    files_n = sorted(p.name for p in out_n.glob("*.fq.gz"))
    assert files_n == sorted(p.name for p in out_p.glob("*.fq.gz"))
    for name in files_n:
        a = gzip.open(out_n / name).read()
        b = gzip.open(out_p / name).read()
        assert a == b, f"{name} differs (seed={seed})"
    assert (out_n / "demux-metrics.txt").read_text() == (
        out_p / "demux-metrics.txt"
    ).read_text()
