#!/usr/bin/env python3
"""On-card smoke test of the demux main path.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py               # one card: phases (a), (b), (c)
    python chip_smoke.py --four-cards  # four cards: the multi-device path only

One card, ``--matcher device`` throughout, so the card assigns every read:

(a) a seeded dual-index paired-end run (I1 8 bp, R1 100 bp, R2 100 bp, I2
    9 bp; 96 samples; max-mismatches 1, min-delta 2; 2^22 reads) demuxed
    through ``run_demux``, compared byte for byte (decompressed FASTQs and
    ``demux-metrics.txt``) with the host matcher through the CLI
    (``--matcher host``), and on a 500K-read slice with the Python
    reference engine (``--engine numpy``);
(b) the device matcher on 2^17-read windows at K=8,192 (16 bp), against
    the NumPy spec on a row subset and the C++ pigeonhole matcher on the
    whole window;
(c) the same at the 737,280-barcode single-cell whitelist with device
    placement forced, the spec chunked over K on a 512-row subset.

``--four-cards`` runs only what exists across cards: run (a) with
``--devices 4`` (batch-sharded) against the host matcher, and the 737K
matcher on the 1x4 (whitelist-sharded), 4x1 and 2x2 meshes against the
pigeonhole matcher and the spec subset.

Any mismatch or exception exits non-zero.  The script refuses to run (exit
2, no result line) when JAX's backend is not a GPU, when the package is not
next to this file, or when the native engine does not build.  The last line
of a passing run is one JSON object with the device JAX reports.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: run (a)'s shape (the dual-index paired-end headline configuration)
N_SAMPLES, BC1, BC2, TEMPLATE = 96, 8, 9, 100
N_READS = 1 << 22
SLICE_READS = 500_000
WINDOW = 1 << 17
MID_K, BIG_K, BIG_L = 8192, 737_280, 16
MAX_MM, MIN_DELTA = 1, 2


def refuse(msg: str) -> None:
    print(f"chip_smoke: refusing to run: {msg}", file=sys.stderr)
    sys.exit(2)


def log(msg: str) -> None:
    print(msg, flush=True)


class Check(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Check(what)


# --------------------------------------------------------------------------
# seeded inputs
# --------------------------------------------------------------------------


def random_whitelist(np, k: int, length: int, seed: int):
    """``[k, length]`` unique ACGT codes (0..3)."""
    rng = np.random.default_rng(seed)
    vals = np.unique(rng.integers(0, 4 ** length, size=int(k * 1.05) + 64))
    vals = rng.permutation(vals)[:k]
    check(len(vals) == k, "whitelist draw too small")
    codes = np.empty((k, length), dtype=np.uint8)
    for j in range(length):
        codes[:, j] = vals % 4
        vals //= 4
    return codes


def fastq_block(np, names, seq, qual):
    """FASTQ bytes for fixed-width rows: ``names`` [n, h] (with '@'),
    ``seq``/``qual`` [n, w] ASCII."""
    n, w = seq.shape
    nl = np.full((n, 1), ord("\n"), np.uint8)
    plus = np.frombuffer(b"\n+\n", np.uint8)[None, :].repeat(n, 0)
    return np.concatenate([names, nl, seq, plus, qual, nl], axis=1).tobytes()


def write_run(np, native_io, tmp: Path, barcodes_ascii, n_reads, slice_reads, seed):
    """Dual-index PE run as BGZF FASTQs: random template bases, binned
    qualities, uniform samples, ~10% one-mismatch index reads, ~1% reads
    with an N index cycle.  Also writes the first ``slice_reads`` records
    as a separate run."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    bins = np.frombuffer(b"#-8F", np.uint8)  # binned Q2, Q12, Q23, Q37
    bin_p = [0.02, 0.08, 0.2, 0.7]
    files = ("i1", "r1", "r2", "i2")
    full = {n: tmp / f"run_{n}.fq.gz" for n in files}
    part = {n: tmp / f"slice_{n}.fq.gz" for n in files}
    ws = {n: native_io.NativeBgzfWriter(p, 1, threads=3) for n, p in full.items()}
    ws_s = {n: native_io.NativeBgzfWriter(p, 1, threads=1) for n, p in part.items()}
    chunk = 1 << 18
    for lo in range(0, n_reads, chunk):
        n = min(chunk, n_reads - lo)
        idx = np.arange(lo, lo + n, dtype=np.int64)
        digits = (idx[:, None] // 10 ** np.arange(9, -1, -1)) % 10 + ord("0")
        names = np.concatenate(
            [
                np.frombuffer(b"@SMOKE:1:FC:1:", np.uint8)[None, :].repeat(n, 0),
                digits.astype(np.uint8),
                np.frombuffer(b" 1:N:0:0", np.uint8)[None, :].repeat(n, 0),
            ],
            axis=1,
        )
        bc = barcodes_ascii[rng.integers(0, len(barcodes_ascii), size=n)].copy()
        mut = rng.random(n) < 0.10
        pos = rng.integers(0, BC1 + BC2, size=n)
        rows = np.nonzero(mut)[0]
        old = bc[rows, pos[rows]]
        shift = rng.integers(1, 4, size=len(rows))
        code = (np.searchsorted(acgt, old) + shift) % 4
        bc[rows, pos[rows]] = acgt[code]
        ncyc = rng.random(n) < 0.01
        rows = np.nonzero(ncyc)[0]
        bc[rows, rng.integers(0, BC1 + BC2, size=len(rows))] = ord("N")
        blocks = {
            "i1": (bc[:, :BC1], bins[rng.choice(4, size=(n, BC1), p=bin_p)]),
            "i2": (bc[:, BC1:], bins[rng.choice(4, size=(n, BC2), p=bin_p)]),
        }
        for r in ("r1", "r2"):
            blocks[r] = (
                acgt[rng.integers(0, 4, size=(n, TEMPLATE))],
                bins[rng.choice(4, size=(n, TEMPLATE), p=bin_p)],
            )
        for name, (seq, qual) in blocks.items():
            ws[name].write(fastq_block(np, names, seq, qual))
            if lo < slice_reads:
                m = min(n, slice_reads - lo)
                ws_s[name].write(fastq_block(np, names[:m], seq[:m], qual[:m]))
    for w in list(ws.values()) + list(ws_s.values()):
        w.close()
    return [full[n] for n in files], [part[n] for n in files]


def write_metadata(tmp: Path, barcodes) -> Path:
    meta = tmp / "metadata.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"S{i:03d}\t{b}\n" for i, b in enumerate(barcodes))
    )
    return meta


def same_outputs(a: Path, b: Path) -> int:
    """Byte-compare the decompressed FASTQs and metrics of two runs;
    returns the number of files compared."""
    names = sorted({p.name for p in a.glob("*.fq.gz")} | {p.name for p in b.glob("*.fq.gz")})
    check(bool(names), f"no outputs in {a}")
    for name in names:
        check((a / name).exists() and (b / name).exists(), f"{name} missing on one side")
        check(
            gzip.decompress((a / name).read_bytes())
            == gzip.decompress((b / name).read_bytes()),
            f"{name} differs between {a.name} and {b.name}",
        )
    check(
        (a / "demux-metrics.txt").read_text() == (b / "demux-metrics.txt").read_text(),
        f"demux-metrics.txt differs between {a.name} and {b.name}",
    )
    return len(names)


# --------------------------------------------------------------------------
# matcher windows and references
# --------------------------------------------------------------------------


def pack_bit2(np, codes):
    w = -(-codes.shape[1] // 4) * 4
    p = np.zeros((codes.shape[0], w), np.uint8)
    p[:, : codes.shape[1]] = codes
    return (p[:, 0::4] | (p[:, 1::4] << 2) | (p[:, 2::4] << 4) | (p[:, 3::4] << 6)).astype(np.uint8)


def pack_nib4(np, codes):
    m = (np.uint8(1) << codes).astype(np.uint8)  # A,C,G,T -> masks 1,2,4,8
    if m.shape[1] % 2:
        m = np.concatenate([m, np.ones((m.shape[0], 1), np.uint8)], axis=1)
    return (m[:, 0::2] | (m[:, 1::2] << 4)).astype(np.uint8)


def matcher_windows(np, codes, n_windows, seed):
    """2^17-read windows drawn uniformly from the whitelist: ~10% with one
    mismatch, ~5% random reads (no-match)."""
    rng = np.random.default_rng(seed)
    k, length = codes.shape
    out = []
    for _ in range(n_windows):
        obs = codes[rng.integers(0, k, size=WINDOW)].copy()
        rows = np.nonzero(rng.random(WINDOW) < 0.10)[0]
        pos = rng.integers(0, length, size=len(rows))
        obs[rows, pos] = (obs[rows, pos] + rng.integers(1, 4, size=len(rows))) % 4
        rnd = np.nonzero(rng.random(WINDOW) < 0.05)[0]
        obs[rnd] = rng.integers(0, 4, size=(len(rnd), length))
        out.append(obs)
    return out


def spec_chunked(np, obs_codes, expected, k_chunk=32768):
    """``assign_batch_np`` over whitelist chunks, merged in index order with
    the first-index tie-break (the spec itself is [B, K] in memory)."""
    from fqtk_tpu.ops.matcher import MAX_COUNT, ExpectedSet, assign_batch_np

    acgt = np.frombuffer(b"ACGT", np.uint8)
    obs = acgt[obs_codes]
    n = len(obs)
    best = np.full(n, MAX_COUNT + 1, np.int64)
    idx = np.zeros(n, np.int64)
    nxt = np.full(n, MAX_COUNT, np.int64)
    for lo in range(0, expected.count, k_chunk):
        masks = expected.masks[lo:lo + k_chunk]
        part = ExpectedSet(masks, expected.max_ns_in_barcodes, expected.length, len(masks))
        # gates off (mm = L, delta 0): we need the raw top-2 of this chunk
        cidx, cb, cn = assign_batch_np(obs, part, expected.length, 0)
        take = cb < best
        nxt = np.where(take, np.minimum(best, cn), np.minimum(nxt, cb))
        idx = np.where(take, cidx + lo, idx)
        best = np.where(take, cb, best)
    if expected.count == 1:
        nxt[:] = MAX_COUNT
    ok = (best <= MAX_MM) & (nxt - best >= MIN_DELTA)
    return np.where(ok, idx, expected.count)


def matcher_phase(np, tag, card, codes, assign, expected, pigeon, n_spec):
    """Run ``assign`` on seeded windows; compare with the pigeonhole
    matcher (whole window) and the spec (first ``n_spec`` rows); return
    the per-window call times."""
    wins = matcher_windows(np, codes, 4, seed=len(codes))
    times = []
    for i, obs in enumerate(wins):
        packed = pack_bit2(np, obs)
        t0 = time.perf_counter()
        got = np.asarray(assign(packed)).astype(np.int64)
        times.append(time.perf_counter() - t0)
        check(got.shape == (WINDOW,), f"{tag}: shape {got.shape}")
        if i == 0:
            ref = np.asarray(pigeon.assign(pack_nib4(np, obs))).astype(np.int64)
            bad = int((got != ref).sum())
            check(bad == 0, f"{tag}: {bad} of {WINDOW} reads differ from the pigeonhole matcher")
            spec = spec_chunked(np, obs[:n_spec], expected)
            bad = int((got[:n_spec] != spec).sum())
            check(bad == 0, f"{tag}: {bad} of {n_spec} reads differ from the NumPy spec")
            log(
                f"{tag}: window 0 matches pigeonhole ({WINDOW} reads) and spec "
                f"({n_spec} reads); {float((got < expected.count).mean()):.4f} assigned"
            )
    steady = sorted(times[1:])
    log(
        f"{tag}: device window {steady[len(steady) // 2] * 1e3:.3f} ms median "
        f"(first call {times[0]:.2f} s incl. compile; {WINDOW} reads, host array in, "
        f"assignments back) [{card}]"
    )
    return times


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def demux_cfg(inputs, meta, out, **kw):
    from fqtk_tpu.runtime.demux import DemuxConfig

    return DemuxConfig(
        inputs=list(inputs),
        read_structures=[f"{BC1}B", f"{TEMPLATE}T", f"{TEMPLATE}T", f"{BC2}B"],
        sample_metadata=meta,
        output=out,
        max_mismatches=MAX_MM,
        min_mismatch_delta=MIN_DELTA,
        **kw,
    )


def host_cli_run(inputs, meta, out) -> None:
    from fqtk_tpu.cli import main as cli_main

    argv = ["demux", "-i", *map(str, inputs), "-r", f"{BC1}B", f"{TEMPLATE}T",
            f"{TEMPLATE}T", f"{BC2}B", "-s", str(meta), "-o", str(out),
            "--max-mismatches", str(MAX_MM), "--min-mismatch-delta", str(MIN_DELTA),
            "--matcher", "host"]
    check(cli_main(argv) == 0, "host-matcher CLI run failed")


def phase_a(np, native_io, tmp: Path, card: str, devices: int) -> None:
    from fqtk_tpu.runtime.demux import run_demux

    acgt = np.frombuffer(b"ACGT", np.uint8)
    codes = random_whitelist(np, N_SAMPLES, BC1 + BC2, seed=96)
    barcodes = [bytes(r).decode() for r in acgt[codes]]
    meta = write_metadata(tmp, barcodes)
    t0 = time.perf_counter()
    full, part = write_run(np, native_io, tmp, acgt[codes], N_READS, SLICE_READS, seed=2024)
    log(f"(a) wrote {N_READS} reads x 4 FASTQs in {time.perf_counter() - t0:.1f} s")

    out_dev = tmp / "a_device"
    t0 = time.perf_counter()
    res = run_demux(demux_cfg(full, meta, out_dev, matcher="device", devices=devices))
    wall = time.perf_counter() - t0
    check(res.total_templates == N_READS, f"(a) device run counted {res.total_templates}")
    check(res.matcher.startswith("device:"), f"(a) placement was {res.matcher!r}")
    log(
        f"(a) device run: matcher {res.matcher}; {N_READS} reads in {wall:.2f} s = "
        f"{N_READS / wall:.0f} reads/s (first run, compile included; "
        f"stage times {json.dumps({k: round(v, 3) for k, v in res.timings.items() if k in ('assign', 'dispatch', 'acquire_wait', 'submit', 'finish')})}) [{card}]"
    )
    t0 = time.perf_counter()
    res = run_demux(demux_cfg(full, meta, tmp / "a_device2", matcher="device", devices=devices))
    wall = time.perf_counter() - t0
    log(f"(a) device run, warm: {N_READS} reads in {wall:.2f} s = {N_READS / wall:.0f} reads/s [{card}]")
    n = same_outputs(out_dev, tmp / "a_device2")
    out_host = tmp / "a_host"
    t0 = time.perf_counter()
    host_cli_run(full, meta, out_host)
    wall = time.perf_counter() - t0
    log(f"(a) host-matcher CLI run: {N_READS} reads in {wall:.2f} s = {N_READS / wall:.0f} reads/s")
    n = same_outputs(out_dev, out_host)
    log(f"(a) device == host matcher: {n} FASTQs + metrics byte-identical")

    if devices == 1:
        from fqtk_tpu.ops.matcher import ExpectedSet

        auto_placement("(a) dual-index", ExpectedSet.from_barcodes(barcodes), barcodes)
        run_demux(demux_cfg(part, meta, tmp / "s_device", matcher="device", devices=1))
        t0 = time.perf_counter()
        run_demux(demux_cfg(part, meta, tmp / "s_numpy", engine="numpy"))
        log(f"(a) numpy reference engine on the {SLICE_READS}-read slice: {time.perf_counter() - t0:.1f} s")
        n = same_outputs(tmp / "s_device", tmp / "s_numpy")
        log(f"(a) device == numpy engine on the slice: {n} FASTQs + metrics byte-identical")


def whitelist_and_matchers(np, k, seed):
    from fqtk_tpu.io import native as native_io
    from fqtk_tpu.ops.matcher import ExpectedSet

    acgt = np.frombuffer(b"ACGT", np.uint8)
    codes = random_whitelist(np, k, BIG_L, seed=seed)
    barcodes = [bytes(r).decode() for r in acgt[codes]]
    expected = ExpectedSet.from_barcodes(barcodes)
    pigeon = native_io.NativeBigKMatcher(barcodes, MAX_MM, MIN_DELTA, threads=os.cpu_count() or 8)
    return codes, barcodes, expected, pigeon


def phase_matcher(np, tag, card, k, n_spec) -> None:
    from fqtk_tpu.runtime import demux as dmod

    codes, barcodes, expected, pigeon = whitelist_and_matchers(np, k, seed=k)
    cfg = dmod.DemuxConfig(
        inputs=[], read_structures=[], sample_metadata=Path("."), output=Path("."),
        max_mismatches=MAX_MM, min_mismatch_delta=MIN_DELTA, matcher="device", devices=1,
    )
    assign, pack_mode, host = dmod._make_device_assign_fn(cfg, expected, barcodes)
    check(not host and pack_mode == "bit2", f"{tag}: placement went to the host")
    log(f"{tag}: K={k}, forced device placement -> {assign.matcher}")
    check(assign.matcher == "device:triton-kernel", f"{tag}: {assign.matcher}")
    matcher_phase(np, tag, card, codes, assign, expected, pigeon, n_spec)
    auto_placement(tag, expected, barcodes)
    pigeon.close()


def auto_placement(tag, expected, barcodes) -> None:
    """Report what ``--matcher auto`` picks for this whitelist here."""
    from fqtk_tpu.runtime import demux as dmod

    cfg = dmod.DemuxConfig(
        inputs=[], read_structures=[], sample_metadata=Path("."), output=Path("."),
        max_mismatches=MAX_MM, min_mismatch_delta=MIN_DELTA, devices=1,
    )
    assign, _, _ = dmod._make_device_assign_fn(cfg, expected, barcodes)
    log(f"{tag}: auto placement (K={expected.count}) -> {assign.matcher} "
        f"{json.dumps(getattr(assign, 'crossover', {}))}")


def phase_mesh(np, card) -> None:
    import jax

    from fqtk_tpu.parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    codes, _, expected, pigeon = whitelist_and_matchers(np, BIG_K, seed=BIG_K)
    for nb, nw in ((1, 4), (4, 1), (2, 2)):
        mesh = make_demux_mesh(n_batch=nb, n_whitelist=nw, devices=jax.devices()[:4])
        fn = make_sharded_assign_fn(
            expected, MAX_MM, MIN_DELTA, mesh, packed2=True, compact_output=False,
            with_counts=False, use_kernel=True,
        )
        matcher_phase(np, f"(mesh {nb}x{nw}) 737K", card, codes, fn, expected, pigeon, 512)
    pigeon.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path and its comparisons")
    args = ap.parse_args()
    n_cards = 4 if args.four_cards else 1

    sys.path.insert(0, str(ROOT))
    try:
        import fqtk_tpu
    except ImportError:
        refuse("the fqtk_tpu package is not next to chip_smoke.py; run it "
               "from the root of a checkout")
    if Path(fqtk_tpu.__file__).resolve().parent.parent != ROOT:
        refuse(f"fqtk_tpu imported from {fqtk_tpu.__file__}, not from {ROOT}")
    from fqtk_tpu.utils.jaxcache import enable_compilation_cache

    cache = enable_compilation_cache()
    import jax
    import numpy as np

    if jax.default_backend() != "gpu":
        refuse(f"JAX backend is {jax.default_backend()!r}, not a GPU")
    devs = jax.devices()
    if len(devs) < n_cards:
        refuse(f"{n_cards} cards needed, JAX sees {len(devs)}")
    from fqtk_tpu.io import native as native_io

    try:
        native_io.get_lib()
    except native_io.NativeLibraryError as e:
        refuse(f"the native engine did not build or load: {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
    log(f"card: {card} (nvidia-smi; {len(smi)} visible)")
    log(f"jax {jax.__version__}: platform {devs[0].platform}, kind {devs[0].device_kind}, "
        f"{len(devs)} device(s); compile cache {cache}")
    log(f"native engine: deflate backend {native_io.deflate_backend()}, "
        f"SIMD level {native_io.simd_level()}")
    os.environ["FQTK_MEASURE_CROSSOVER"] = "1"  # placement probes run fresh

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        tmp = Path(td)
        if args.four_cards:
            phase_a(np, native_io, tmp, card, devices=4)
            phase_mesh(np, card)
        else:
            phase_a(np, native_io, tmp, card, devices=1)
            phase_matcher(np, "(b) mid-K", card, MID_K, n_spec=4096)
            phase_matcher(np, "(c) 737K", card, BIG_K, n_spec=512)
    log(f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {"platform": devs[0].platform, "kind": devs[0].device_kind,
                   "count": len(devs)},
    }))


if __name__ == "__main__":
    main()
