"""Benchmark harness: prints ONE JSON line with the headline metric.

Headline: end-to-end ``demux`` reads/sec on the dual-index paired-end config
(BASELINE.json config #2: I1+I2+R1+R2, 8B+9B, 96 samples, max-mismatches=1,
min-delta=2) with the native engine (C++ pipelined host I/O + device or host
matcher), measured on this machine's default JAX backend; the output names
that device.  The ``configs`` array additionally covers every BASELINE.md
benchmark config:

1. single-end inline index (17B+T, 16 samples, 0 mismatches)
2. dual-index paired-end (the headline)
3. IUPAC/N expected barcodes (same program shape as #1 — the whitelist is a
   runtime argument, so no extra XLA compile)
4. single-cell 16B-style 737K-barcode whitelist — matcher-level (a 737K-
   sample demux e2e is impossible for ANY implementation: fd limits), the
   product's pigeonhole path vs the reference-architecture scalar matcher
5. variable-length ``+`` read structures, paired-end (same compiled shape
   as #2)

Each e2e config reports ``vs_config_baseline`` against the measured
reference-architecture proxy run ON THE SAME INPUTS (scripts/
measure_baseline.py documents the proxy and its generous-to-baseline
deltas).  A warmup pass per program shape runs first so compiles are
excluded; the persistent compilation cache is enabled as well.  Device
matcher legs time the production per-window call (host array in,
assignments back on the host) at the production window of 2^17 reads.
"""

import ctypes
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

RUST_BASELINE_READS_PER_SEC_ESTIMATE = 1.5e6

# Run lengths: long enough that the fixed per-run bubbles (process setup,
# thread spawn, first-window fill, end-of-run flush — ~80-100ms measured
# wall even with writer opens overlapped into the fill, r5) amortize to
# ~2% of wall, so e2e rates and frac_of_ceiling reflect the steady-state
# pipeline, not process startup.  Production demux jobs run minutes to
# hours; a 2.4s measurement window charged ~4% of frac to startup alone.
# Both sides of every A/B (product and reference proxy) run the same
# lengths, so the ratios are unaffected either way.
N_READS = 8_000_000
N_READS_SECONDARY = 6_000_000
WARMUP_READS = 2_000
K = 96
BC1, BC2 = 8, 9
L = BC1 + BC2
TEMPLATE_LEN = 100
BATCH = 1 << 17


def rust_baseline() -> tuple:
    """(reads_per_sec, note) — measured proxy when available."""
    p = Path(__file__).resolve().parent / "BASELINE_MEASURED.json"
    if p.exists():
        d = json.loads(p.read_text())
        return float(d["value"]), (
            "vs measured reference-architecture proxy on identical inputs in "
            "the same noise window (best-of-4 both sides; pinned best-ever "
            f"proxy {d['value']/1e6:.2f}M reads/s, {d['threads']}-thread "
            "config, under vs_pinned_best_proxy)"
        )
    return RUST_BASELINE_READS_PER_SEC_ESTIMATE, (
        "vs est. 1.5M reads/s 16-thread Rust fqtk (unmeasured; no Rust "
        "toolchain in image)"
    )


def make_whitelist(k, length, seed=7, alphabet="ACGT"):
    rng = np.random.default_rng(seed)
    out, seen = [], set()
    while len(out) < k:
        bc = "".join(rng.choice(list(alphabet), size=length))
        if bc not in seen:
            seen.add(bc)
            out.append(bc)
    return out


def _writers(paths):
    import gzip

    from fqtk_tpu.io import native as native_io

    if native_io.available():
        return {
            n: native_io.NativeBgzfWriter(p, 1, threads=3)
            for n, p in paths.items()
        }
    return {n: gzip.open(p, "wb", compresslevel=1) for n, p in paths.items()}  # pragma: no cover


def write_metadata(tmp, barcodes, name="metadata.tsv"):
    meta = tmp / name
    with open(meta, "w") as fh:
        fh.write("sample_id\tbarcode\n")
        for i, b in enumerate(barcodes):
            fh.write(f"S{i:04d}\t{b}\n")
    return meta


def write_inputs(tmp: Path, barcodes, n_reads=N_READS, name=""):
    """Dual-index PE inputs (headline config).  BGZF-compressed — the
    reference's documented input workflow (``... | bgzip -c``)."""
    rng = np.random.default_rng(11)
    meta = write_metadata(tmp, barcodes, f"{name}metadata.tsv")
    choices = rng.integers(0, K, size=n_reads)
    mism = rng.integers(0, 10, size=n_reads) == 0
    tmpl = ("ACGT" * 25).encode()
    qual = b"I" * TEMPLATE_LEN
    qb1, qb2 = b"I" * BC1, b"I" * BC2
    paths = {n: tmp / f"{name}{n}.fq.gz" for n in ("i1", "r1", "r2", "i2")}
    fhs = _writers(paths)
    bcs = [barcodes[c].encode() for c in range(K)]
    chunk = 100_000
    for lo in range(0, n_reads, chunk):
        hi = min(lo + chunk, n_reads)
        p1, p2, pr = [], [], []
        for i in range(lo, hi):
            bc = bcs[choices[i]]
            b1, b2 = bc[:BC1], bc[BC1:]
            if mism[i]:
                b1 = (b"T" if b1[:1] != b"T" else b"G") + b1[1:]
            # formatted per chunk: a 2M-element header list up front is a
            # ~200MB transient for nothing
            h = b"@inst:1:AB:1:2:%d:3 1:N:0:0" % i
            p1.append(h + b"\n" + b1 + b"\n+\n" + qb1 + b"\n")
            p2.append(h + b"\n" + b2 + b"\n+\n" + qb2 + b"\n")
            pr.append(h + b"\n" + tmpl + b"\n+\n" + qual + b"\n")
        fhs["i1"].write(b"".join(p1))
        fhs["i2"].write(b"".join(p2))
        block = b"".join(pr)
        fhs["r1"].write(block)
        fhs["r2"].write(block)
    for fh in fhs.values():
        fh.close()
    return paths, meta


def write_single_end_inputs(tmp, barcodes, n_reads, name, var_template=False):
    """One FASTQ with an inline index: ``{L}B`` + template (config #1/#3);
    ``var_template=True`` varies template length (config #5 inputs)."""
    rng = np.random.default_rng(13)
    length = len(barcodes[0])
    choices = rng.integers(0, len(barcodes), size=n_reads)
    path = tmp / f"{name}.fq.gz"
    fh = _writers({"x": path})["x"]
    tmpl_full = ("ACGT" * 40).encode()
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
    fh.close()
    return path, length


#: published dense tensor-core peaks per card, keyed by jax device_kind:
#: (bf16 FLOP/s, int8 OP/s), FMA = 2 ops.  Source: NVIDIA H100 Tensor Core
#: GPU data sheet, SXM5 part, without sparsity, at the full 700 W power
#: limit (a card capped lower cannot hold its top clock under load).  A
#: kind not listed has no peak: utilization is then reported as None.
_PEAK_OPS = {
    "NVIDIA H100 80GB HBM3": (9.89e14, 1.979e15),
}


def _peak_ops(dtype: str, kind: str = None):
    """(peak ops/s for ``dtype`` or None, device kind)."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    peaks = _PEAK_OPS.get(kind)
    if peaks is None:
        return None, kind
    return (peaks[1] if dtype == "int8" else peaks[0]), kind


def matcher_ops_per_read(k: int, length: int) -> float:
    """int8 ops one read needs in the fused matcher: a one-hot over the 4
    bit2 classes at each position against every barcode (2 ops per MAC)."""
    return 2.0 * k * 4 * length


def device_matcher(barcodes, max_mm=1, delta=2):
    """The production device matcher for ``barcodes`` (``--matcher device``
    on one device), as the demux driver builds it."""
    from fqtk_tpu.ops.matcher import ExpectedSet
    from fqtk_tpu.runtime import demux as dmod

    cfg = dmod.DemuxConfig(
        inputs=[], read_structures=[], sample_metadata=Path("."),
        output=Path("."), max_mismatches=max_mm, min_mismatch_delta=delta,
        matcher="device", devices=1,
    )
    expected = ExpectedSet.from_barcodes(barcodes)
    assign, pack_mode, host = dmod._make_device_assign_fn(cfg, expected, barcodes)
    assert pack_mode == "bit2" and not host, (pack_mode, host)
    return assign


def pack_bit2(byts):
    """[B, L] pure-ACGT ASCII -> the engine's bit2 window layout."""
    code = np.zeros(256, dtype=np.uint8)
    for c, ch in zip((0, 1, 2, 3), b"ACGT"):
        code[ch] = c
    b, length = byts.shape
    cc = np.zeros((b, -(-length // 4) * 4), dtype=np.uint8)
    cc[:, :length] = code[byts]
    return (
        cc[:, 0::4] | (cc[:, 1::4] << 2) | (cc[:, 2::4] << 4) | (cc[:, 3::4] << 6)
    ).astype(np.uint8)


def window_rate(assign, windows, iters=4):
    """Median per-window call time -> reads/s: host array in, assignments
    back on the host (the unit the pipeline dispatches).  The last window
    warms (compiles) first."""
    np.asarray(assign(windows[-1]))
    times = []
    for i in range(iters):
        w = windows[i % (len(windows) - 1)]
        t0 = time.perf_counter()
        np.asarray(assign(w))
        times.append(time.perf_counter() - t0)
    times.sort()
    return len(windows[0]) / times[len(times) // 2]


def device_entry(assign, k, length, rate):
    """Device fields of a matcher leg: kind, achieved int8 ops, utilization
    of the published peak (None for a kind without one)."""
    peak, kind = _peak_ops("int8")
    ops = matcher_ops_per_read(k, length) * rate
    return {
        "device_kind": kind,
        "matcher": getattr(assign, "matcher", None),
        "window_reads_per_sec": round(rate, 1),
        "achieved_int8_tops": round(ops / 1e12, 3),
        "frac_of_int8_peak": round(ops / peak, 4) if peak else None,
    }


def bench_kernel(barcodes):
    """The headline whitelist's device matcher on production windows."""
    assign = device_matcher(barcodes)
    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    windows = [pack_bit2(rng.choice(bases, size=(BATCH, L))) for _ in range(4)]
    rate = window_rate(assign, windows)
    return rate, device_entry(assign, len(barcodes), L, rate)


def _demux_cfg(inputs, structures, meta, out_dir, max_mm=1, delta=2):
    from fqtk_tpu.runtime.demux import DemuxConfig

    return DemuxConfig(
        inputs=list(inputs),
        read_structures=list(structures),
        sample_metadata=meta,
        output=out_dir,
        max_mismatches=max_mm,
        min_mismatch_delta=delta,
        batch_size=BATCH,
        engine="auto",
        # experiment knob for scripts/ab_e2e.py arms (pool size = threads-2)
        threads=int(os.environ.get("FQTK_BENCH_THREADS", "8")),
    )


def host_speed_of_light(e2e_rps, n_reads, stage_timings, inputs=None):
    """E2e "speed-of-light" on THIS host: every demux architecture (ours and
    the reference's) must inflate, scan, reformat, and re-deflate the same
    bytes.  Those irreducible stages' measured thread-CPU, spread perfectly
    over all cores with a zero-cost matcher, bound any implementation's
    throughput here; report that bound and our fraction of it.

    The flat-spread ceiling is OPTIMISTIC for single-input configs: the
    bench inputs are single-member gzip streams, and inflate within one
    deflate member is inherently serial (each block's dictionary is the
    previous output), so no implementation can spread the slowest input's
    inflate CPU across cores.  When `inputs` is given, a decompress-only
    calibration pass measures that serial bound and the report includes
    the tighter min(ceiling, serial bound) plus our fraction of it."""
    io_keys = ("native_parse", "native_gate_pack", "native_route",
               "native_compress")
    io_core_s = sum(stage_timings.get(k, 0.0) for k in io_keys)
    if io_core_s <= 0:
        return None
    cores = os.cpu_count() or 1
    ceiling = n_reads * cores / io_core_s
    out = {
        "cores": cores,
        "io_core_seconds": round(io_core_s, 3),
        "assign_free_ceiling_reads_per_sec": round(ceiling, 1),
        "frac_of_ceiling": round(e2e_rps / ceiling, 3),
        "note": "ceiling = measured inflate+parse+route+deflate thread-CPU "
        "(paid by ANY implementation at this gzip level) spread over all "
        "cores with a free matcher",
    }
    # Hypervisor steal during the measured run: stolen vCPU time stretches
    # wall without adding thread-CPU, so it depresses frac_of_ceiling
    # through no fault of the pipeline.  Report the frac against the cores
    # the VM actually got (the honest pipeline-quality number; raw frac
    # above stays the conservative headline).
    steal = stage_timings.get("steal_frac", 0.0)
    if steal > 0:
        avail_ceiling = n_reads * cores * (1.0 - steal) / io_core_s
        out["steal_frac_during_run"] = steal
        out["frac_of_available_ceiling"] = round(e2e_rps / avail_ceiling, 3)
    # Per-input serial floor: record framing + extraction within one FASTQ
    # stream is sequential, so for n_inputs < cores the flat spread is
    # optimistic and the slowest input's parse CPU caps any implementation
    # (same accounting as the subsample entry; assumes symmetric inputs).
    parse_s = stage_timings.get("native_parse", 0.0)
    if inputs and parse_s > 0 and len(inputs) < cores:
        serial_bound = n_reads * len(inputs) / parse_s
        achievable = min(ceiling, serial_bound)
        out.setdefault(
            "per_input_serial_parse_bound_reads_per_sec", round(serial_bound, 1)
        )
        out["achievable_ceiling_reads_per_sec"] = round(achievable, 1)
        out["frac_of_achievable"] = round(e2e_rps / achievable, 3)
    if inputs:
        try:
            from fqtk_tpu.io import native as native_io

            if native_io.available():
                results = [native_io.inflate_bench(p) for p in inputs]
                # the serial bound only exists for single-member gzip
                # inputs; multi-member/BGZF streams are block-parallel
                # decodable in principle, so no implementation-independent
                # serial cap can be claimed for them
                serial = [cpu for _, cpu, kind in results if kind == "gzip"]
                if serial:
                    serial_s = max(serial)
                    serial_bound = n_reads / serial_s
                    achievable = min(ceiling, serial_bound)
                    out.update(
                        serial_inflate_s_max=round(serial_s, 3),
                        serial_inflate_bound_reads_per_sec=round(
                            serial_bound, 1
                        ),
                        achievable_ceiling_reads_per_sec=round(achievable, 1),
                        frac_of_achievable=round(e2e_rps / achievable, 3),
                        serial_note="single-member gzip input(s): the "
                        "slowest one's measured serial inflate CPU caps ANY "
                        "implementation; achievable = min(flat-spread "
                        "ceiling, serial bound)",
                    )
                else:
                    out["input_kind"] = results[0][2] if results else None
        except Exception:
            pass  # calibration is advisory; never fail the bench over it
    return out


def _read_steal_ticks():
    """(steal_ticks, wall_s) from /proc/stat — field 8 of the aggregate cpu
    line is core-ticks stolen by the hypervisor (other tenants running on
    our vCPUs).  Stolen cores stretch wall time without adding thread-CPU,
    so they depress frac_of_ceiling through no fault of the pipeline."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        return int(parts[8]), time.perf_counter()
    except Exception:
        return 0, time.perf_counter()


def run_e2e(tmp, inputs, structures, meta, n_reads, tag, trials=2,
            max_mm=1, delta=2, warm_inputs=None):
    """Best-of-N e2e run; returns (reads_per_sec, timings of best)."""
    from fqtk_tpu.runtime.demux import run_demux

    if warm_inputs is not None:
        run_demux(
            _demux_cfg(
                warm_inputs, structures, meta, tmp / f"warm_{tag}",
                max_mm=max_mm, delta=delta,
            )
        )
    best, best_t = 0.0, {}
    for trial in range(trials):
        s0, w0 = _read_steal_ticks()
        t0 = time.perf_counter()
        result = run_demux(
            _demux_cfg(
                inputs, structures, meta, tmp / f"out_{tag}{trial}",
                max_mm=max_mm, delta=delta,
            )
        )
        dt = time.perf_counter() - t0
        s1, w1 = _read_steal_ticks()
        assert result.total_templates == n_reads, (result.total_templates, n_reads)
        if n_reads / dt > best:
            best = n_reads / dt
            best_t = {k: round(v, 3) for k, v in result.timings.items()}
            # USER_HZ=100; steal is summed over all vCPUs already
            avail = (os.cpu_count() or 1) * (w1 - w0) * 100.0
            best_t["steal_frac"] = round((s1 - s0) / avail, 4) if avail else 0.0
    return best, best_t


def run_refproxy(tmp, inputs, structures, barcodes, n_reads, tag,
                 max_mm=1, delta=2, trials=2, threads=16):
    """Reference-architecture proxy on the same inputs; best-of-N reads/s."""
    from fqtk_tpu.core.read_structure import ReadStructure, SegmentType
    from fqtk_tpu.io import native as native_io

    if not native_io.available():
        return None
    rss = [ReadStructure.from_str(s) for s in structures]
    bc_len = len(barcodes[0])
    best = 0.0
    for trial in range(trials):
        out_dir = tmp / f"proxy_{tag}{trial}"
        out_dir.mkdir()
        engine = native_io.NativeDemuxEngine(
            threads=max(1, threads - 3), compression_level=5
        )
        try:
            for path, rs in zip(inputs, rss):
                engine.add_input(
                    str(path),
                    str(rs),
                    [(s.offset, s.length, s.kind.value) for s in rs],
                )
            n_t = sum(len(rs.segments_by_type(SegmentType.Template)) for rs in rss)
            names = [f"S{i:04d}" for i in range(len(barcodes))] + ["unmatched"]
            for name in names:
                engine.add_sample(
                    [str(out_dir / f"{name}.R{i}.fq.gz") for i in range(1, n_t + 1)]
                )
            engine.configure(
                bc_len=bc_len,
                nocall_budget=max_mm,
                skip_too_few=False,
                first_sample_id="S0000",
                first_barcode=barcodes[0],
                out_types="T",
            )
            t0 = time.perf_counter()
            total = engine.refproxy_run(barcodes, max_mm, delta)
            dt = time.perf_counter() - t0
        finally:
            engine.close()
        assert total == n_reads, (total, n_reads)
        best = max(best, n_reads / dt)
    return best


def run_config_ab(
    tmp, inputs, structures, meta, barcodes, n_reads, tag, trials=2,
    max_mm=1, delta=2, warm_inputs=None, proxy_threads=16,
):
    """Interleaved A/B: alternate product and proxy trials so a VM noise
    phase that flips mid-config hits BOTH sides instead of skewing the
    ratio (sequential best-of-N blocks pair badly across a phase edge).
    Returns (best_e2e, timings_of_best, best_proxy)."""
    best_e2e, best_t, best_proxy = 0.0, {}, 0.0
    for trial in range(trials):
        rps, t = run_e2e(
            tmp, inputs, structures, meta, n_reads, f"{tag}{trial}",
            trials=1, max_mm=max_mm, delta=delta,
            warm_inputs=warm_inputs if trial == 0 else None,
        )
        if rps > best_e2e:
            best_e2e, best_t = rps, t
        p = run_refproxy(
            tmp, inputs, structures, barcodes, n_reads, f"{tag}{trial}",
            max_mm=max_mm, delta=delta, trials=1, threads=proxy_threads,
        )
        if p:
            best_proxy = max(best_proxy, p)
    return best_e2e, best_t, best_proxy


def bench_midk_config():
    """Mid-K (host-matcher cap < K < pigeonhole threshold): the device
    matcher on production windows, built as the demux driver builds it
    (``--matcher device``).  Matcher-level, proxy measured on identical
    reads (reference scalar branch-and-bound)."""
    import ctypes

    from fqtk_tpu.io import native as native_io

    k, length = 8192, 16
    rng = np.random.default_rng(11)
    vals = rng.choice(1 << 28, size=k + 64, replace=False)[:k].astype(np.uint32)
    codes = np.zeros((k, length), dtype=np.uint8)
    v = vals.copy()
    for j in range(length):
        codes[:, j] = v & 3
        v >>= 2
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    bc_bytes = letters[codes]
    barcodes = [bytes(r).decode() for r in bc_bytes]

    def window():
        obs = bc_bytes[rng.integers(0, k, size=BATCH)].copy()
        mut = rng.integers(0, 10, size=BATCH) == 0
        pos = rng.integers(0, length, size=BATCH)
        obs[mut, pos[mut]] = letters[rng.integers(0, 4, size=int(mut.sum()))]
        return obs

    raw = [window() for _ in range(5)]
    assign = device_matcher(barcodes)
    rate = window_rate(assign, [pack_bit2(w) for w in raw])
    obs = raw[0]
    result = {
        "name": "mid_K_8192_16bp_mm1_d2",
        "level": "matcher",
        "reads_per_sec": round(rate, 1),
        **device_entry(assign, k, length, rate),
    }
    lib = native_io.get_lib()
    # idempotent: also declared in bench_bigk_config, but this config
    # must be callable standalone (wrong marshaling segfaults)
    lib.fqtk_refproxy_matcher_bench.restype = ctypes.c_double
    lib.fqtk_refproxy_matcher_bench.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    concat = bc_bytes.tobytes()
    cbuf = (ctypes.c_uint8 * len(concat)).from_buffer_copy(concat)
    n_proxy = 4000
    obs_c = np.ascontiguousarray(obs[:n_proxy])
    proxy_rps = float(
        lib.fqtk_refproxy_matcher_bench(
            cbuf, k, length, 1, 2,
            obs_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_proxy,
        )
    )
    if proxy_rps > 0:
        result["proxy_reads_per_sec"] = round(proxy_rps, 1)
        result["vs_config_baseline"] = round(rate / proxy_rps, 1)
    return result


def bench_bigk_config():
    """Config #4: 737K-barcode whitelist, matcher-level (see module doc)."""
    from fqtk_tpu.core.encoding import ENCODE_LUT
    from fqtk_tpu.io import native as native_io

    if not native_io.available():
        return None
    rng = np.random.default_rng(1)
    k, length = 737_280, 16
    vals = rng.choice(
        np.iinfo(np.uint32).max, size=k + 1000, replace=False
    )[:k].astype(np.uint32)
    codes = np.zeros((k, length), dtype=np.uint8)
    v = vals.copy()
    for j in range(length):
        codes[:, j] = v & 3
        v >>= 2
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    bc_bytes = letters[codes]
    barcodes = [bytes(r).decode() for r in bc_bytes]

    b = 1 << 17
    choice = rng.integers(0, k, size=b)
    obs = bc_bytes[choice].copy()
    mut = rng.integers(0, 10, size=b) == 0
    pos = rng.integers(0, length, size=b)
    obs[mut, pos[mut]] = letters[rng.integers(0, 4, size=int(mut.sum()))]
    masks = ENCODE_LUT[obs].astype(np.uint8)
    packed = (masks[:, 0::2] | (masks[:, 1::2] << 4)).astype(np.uint8)

    # product path: pigeonhole matcher (auto-selected for K >= 65536)
    m = native_io.NativeBigKMatcher(barcodes, 1, 2, threads=4)
    m.assign(packed[:1024])  # warm
    t0 = time.perf_counter()
    out = m.assign(packed)
    dt = time.perf_counter() - t0
    pigeonhole_rps = b / dt
    matched = float((out < k).mean())

    # realistic single-cell distribution: reads cluster on ~8K cells
    # (thousands of reads per cell barcode), where the memo cache engages;
    # the uniform draw above stays the headline (conservative)
    cells = rng.integers(0, k, size=8000)
    obs_sc = bc_bytes[cells[rng.integers(0, 8000, size=b)]].copy()
    mut = rng.integers(0, 10, size=b) == 0
    pos = rng.integers(0, length, size=b)
    obs_sc[mut, pos[mut]] = letters[rng.integers(0, 4, size=int(mut.sum()))]
    masks_sc = ENCODE_LUT[obs_sc].astype(np.uint8)
    packed_sc = (masks_sc[:, 0::2] | (masks_sc[:, 1::2] << 4)).astype(np.uint8)
    m.assign(packed_sc[:4096])  # warm the cache
    t0 = time.perf_counter()
    m.assign(packed_sc)
    clustered_rps = b / (time.perf_counter() - t0)
    m.close()

    # degenerate-whitelist variant: one expected N per barcode exercises
    # the expanded-table path (BigKMatcher iupac mode)
    bc_n = bc_bytes.copy()
    bc_n[np.arange(k), rng.integers(0, length, size=k)] = ord("N")
    mi = native_io.NativeBigKMatcher(
        [bytes(r).decode() for r in bc_n], 1, 2, threads=4
    )
    mi.assign(packed[:1024])
    t0 = time.perf_counter()
    mi.assign(packed)
    iupac_rps = b / (time.perf_counter() - t0)
    mi.close()

    # baseline proxy: the reference's scalar branch-and-bound + cache
    lib = native_io.get_lib()
    lib.fqtk_refproxy_matcher_bench.restype = ctypes.c_double
    lib.fqtk_refproxy_matcher_bench.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    concat = bc_bytes.tobytes()
    cbuf = (ctypes.c_uint8 * len(concat)).from_buffer_copy(concat)
    n_proxy = 2000  # scalar scan is slow; extrapolating from 2K reads
    obs_c = np.ascontiguousarray(obs[:n_proxy])
    proxy_rps = float(
        lib.fqtk_refproxy_matcher_bench(
            cbuf, k, length, 1, 2,
            obs_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_proxy,
        )
    )
    result = {
        "name": "single_cell_737K_whitelist_16B",
        "level": "matcher",
        "reads_per_sec": round(pigeonhole_rps, 1),
        "engine": "pigeonhole (product auto-path for K>=65536)",
        "matched_frac": round(matched, 4),
        "clustered_8k_cells_reads_per_sec": round(clustered_rps, 1),
        "iupac_whitelist_reads_per_sec": round(iupac_rps, 1),
        "proxy_reads_per_sec": round(proxy_rps, 1),
        "vs_config_baseline": round(pigeonhole_rps / proxy_rps, 1)
        if proxy_rps > 0
        else None,
        "note": "737K-sample demux e2e impossible for any implementation "
        "(fd limits); both sides measured matcher-level on identical reads",
    }
    result["device"] = _bench_bigk_device(barcodes, obs)
    return result


def _bench_bigk_device(barcodes, obs):
    """The device matcher on the same 737K whitelist (the path
    ``--matcher device`` and degenerate >16 bp whitelists take), built as
    the demux driver builds it: uniform draws, and the clustered
    single-cell distribution where the driver's window dedup engages
    (thousands of reads per cell barcode shrink the device batch)."""
    k, length = len(barcodes), len(barcodes[0])
    assign = device_matcher(barcodes)
    packed = pack_bit2(obs)
    rng = np.random.default_rng(9)
    windows = [packed[rng.permutation(len(packed))] for _ in range(3)]
    rate = window_rate(assign, windows, iters=3)
    cells = rng.integers(0, len(packed), size=8192)
    clustered = [packed[cells[rng.integers(0, 8192, size=BATCH)]] for _ in range(4)]
    clustered_rate = window_rate(assign, clustered, iters=3)
    return {
        **device_entry(assign, k, length, rate),
        "clustered_8k_cells_window_reads_per_sec": round(clustered_rate, 1),
    }


def bench_subsample_config(tmp: Path, paths):
    """Subsample e2e (PE pair, fraction 0.3) vs the reference-architecture
    proxy: the identical engine forced into the serial record-at-a-time
    lockstep loop with per-record draws folded in (``subsample.rs:175-304``:
    one reader thread + pooled BGZF writers).  The product path adds one
    reader thread per input (the keep mask is pre-drawn, so inputs decouple)
    (decode-ahead is opt-in after the r4 A/B; see DESIGN.md)."""
    from fqtk_tpu.io import native as native_io
    from fqtk_tpu.runtime.subsample import SubsampleConfig, run_subsample
    from fqtk_tpu.utils.chacha import ChaCha8Rng

    if not native_io.available():
        return None
    inputs = [paths["r1"], paths["r2"]]

    # interleaved A/B (see run_config_ab): a noise-phase flip mid-config
    # hits both sides instead of skewing the ratio
    best = 0.0
    proxy_best = 0.0
    best_stats = None
    for trial in range(2):
        cfg = SubsampleConfig(
            inputs=inputs,
            output=tmp / f"sub{trial}",
            fraction=0.3,
            threads=8,
            seed=42,
        )
        t0 = time.perf_counter()
        res = run_subsample(cfg)
        dt = time.perf_counter() - t0
        if res.total_read / dt > best:
            best = res.total_read / dt
            best_stats = res.stage_seconds
        n_subsample_reads = res.total_read

        # generous-to-baseline: the proxy's mask stream uses the fast
        # native ChaCha (~13ns/draw, close to Rust's inline per-record
        # draw) rather than charging it the NumPy stream's ~50ns inside
        # its timed serial loop
        try:
            rng = native_io.NativeChaChaMask(42)
            draw = lambda m: rng.keep_mask(m, 0.3)  # noqa: E731
        except native_io.NativeDemuxError:  # stale .so
            rng = ChaCha8Rng(42)
            draw = lambda m: (  # noqa: E731
                rng.random_f64_batch(m) < 0.3
            ).astype("uint8")
        eng = native_io.NativeSubsampleEngine(threads=7, compression_level=5)
        try:
            for i, p in enumerate(inputs):
                eng.add_input(p, tmp / f"subproxy{trial}.R{i + 1}.fq.gz")
            eng.configure(check_names=True, parallel=False)
            t0 = time.perf_counter()
            total = 0
            while True:
                mask = draw(1 << 16)
                c, _ = eng.process_chunk(mask)
                total += c
                if c < len(mask):
                    break
            eng.finish()
        finally:
            eng.close()
        dt = time.perf_counter() - t0
        proxy_best = max(proxy_best, total / dt)

    entry = {
        "name": "subsample_PE_fraction0.3",
        "level": "e2e",
        "reads_per_sec": round(best, 1),
        "proxy_reads_per_sec": round(proxy_best, 1),
        "vs_config_baseline": round(best / proxy_best, 2) if proxy_best else None,
    }
    # Host-ceiling accounting: subsample's irreducible
    # work is inflate+scan+name-check+record-copy plus BGZF re-deflate of
    # the kept records — measured thread-CPU, spread over all cores.
    if best_stats:
        io_core_s = best_stats["native_work"] + best_stats["native_compress"]
        if io_core_s > 0:
            cores = os.cpu_count() or 1
            ceiling = n_subsample_reads * cores / io_core_s
            entry["host_speed_of_light"] = {
                "cores": cores,
                "io_core_seconds": round(io_core_s, 3),
                "assign_free_ceiling_reads_per_sec": round(ceiling, 1),
                "frac_of_ceiling": round(best / ceiling, 3),
                "note": "ceiling = measured inflate+scan+name-check+copy + "
                "BGZF deflate thread-CPU (paid by ANY implementation at this "
                "gzip level) spread over all cores",
            }
            # The flat spread is unattainable for n_inputs < cores: record
            # framing within one FASTQ stream is inherently sequential, so
            # the slowest input's scan thread-CPU is a serial floor ANY
            # implementation pays.
            work = best_stats["native_work"]
            if work > 0 and len(inputs) < cores:
                serial_bound = n_subsample_reads * len(inputs) / work
                achievable = min(ceiling, serial_bound)
                entry["host_speed_of_light"].update(
                    per_input_serial_bound_reads_per_sec=round(
                        serial_bound, 1
                    ),
                    achievable_ceiling_reads_per_sec=round(achievable, 1),
                    frac_of_achievable=round(best / achievable, 3),
                    serial_note="per-input record framing is sequential; "
                    "bound = n * n_inputs / scan thread-CPU (assumes "
                    "symmetric inputs)",
                )
    return entry


def main():
    from fqtk_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    if jax.default_backend() != "gpu":
        # a measurement without the card is not a device number
        print(f"bench.py: JAX backend is {jax.default_backend()!r}, not a GPU",
              file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    barcodes = make_whitelist(K, L)
    kernel_rps, kernel_device = bench_kernel(barcodes)
    configs = []
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)

        # ---- headline: dual-index PE, 96 samples ----
        wpaths, wmeta = write_inputs(tmp, barcodes, n_reads=WARMUP_READS, name="w_")
        paths, meta = write_inputs(tmp, barcodes, n_reads=N_READS)
        di_inputs = [paths["i1"], paths["r1"], paths["r2"], paths["i2"]]
        di_structs = ["8B", "100T", "100T", "9B"]
        e2e_rps, stage_timings, proxy_di = run_config_ab(
            tmp, di_inputs, di_structs, meta, barcodes, N_READS, "headline",
            trials=4,
            warm_inputs=[wpaths["i1"], wpaths["r1"], wpaths["r2"], wpaths["i2"]],
        )
        configs.append(
            {
                "name": "dual_index_PE_96samples_8B9B_mm1_d2",
                "level": "e2e",
                "reads_per_sec": round(e2e_rps, 1),
                "proxy_reads_per_sec": round(proxy_di, 1) if proxy_di else None,
                "vs_config_baseline": round(e2e_rps / proxy_di, 2) if proxy_di else None,
                "host_speed_of_light": host_speed_of_light(
                    e2e_rps, N_READS, stage_timings, inputs=di_inputs
                ),
            }
        )

        # never lose the whole bench (and the headline line) to one
        # secondary config: record the failure as that config's entry instead
        def guarded(name, fn, *a):
            try:
                entry = fn(*a)
            except Exception as e:
                entry = {"name": name, "error": f"{type(e).__name__}: {e}"[:200]}
            if entry:
                configs.append(entry)

        # ---- config 1: single-end inline 17B+T, 16 samples, mm=0 ----
        def bench_single_end_config():
            se_bcs = make_whitelist(16, 17, seed=21)
            se_meta = write_metadata(tmp, se_bcs, "se_meta.tsv")
            wse, _ = write_single_end_inputs(tmp, se_bcs, WARMUP_READS, "w_se")
            se_path, _ = write_single_end_inputs(
                tmp, se_bcs, N_READS_SECONDARY, "se"
            )
            se_rps, se_t, proxy_se = run_config_ab(
                tmp, [se_path], ["17B+T"], se_meta, se_bcs, N_READS_SECONDARY,
                "se", trials=3, max_mm=0, delta=2, warm_inputs=[wse],
            )
            return {
                "name": "single_end_inline_17B+T_16samples_mm0",
                "level": "e2e",
                "reads_per_sec": round(se_rps, 1),
                "proxy_reads_per_sec": round(proxy_se, 1) if proxy_se else None,
                "vs_config_baseline": round(se_rps / proxy_se, 2) if proxy_se else None,
                "host_speed_of_light": host_speed_of_light(
                    se_rps, N_READS_SECONDARY, se_t, inputs=[se_path]
                ),
            }

        guarded("single_end_inline_17B+T_16samples_mm0", bench_single_end_config)

        # ---- config 3: IUPAC/N expected barcodes (same shape as #1) ----
        def bench_iupac_config():
            iupac_bcs = make_whitelist(16, 17, seed=23)
            iupac_bcs = [
                b[:4] + "N" + b[5:10] + "RY"[i % 2] + b[11:]
                for i, b in enumerate(iupac_bcs)
            ]
            iu_meta = write_metadata(tmp, iupac_bcs, "iu_meta.tsv")
            iu_reads = [b.replace("N", "A").replace("R", "G").replace("Y", "C")
                        for b in iupac_bcs]
            iu_path, _ = write_single_end_inputs(
                tmp, iu_reads, N_READS_SECONDARY, "iu"
            )
            iu_rps, iu_t, proxy_iu = run_config_ab(
                tmp, [iu_path], ["17B+T"], iu_meta, iupac_bcs, N_READS_SECONDARY,
                "iu", trials=3, max_mm=1, delta=2,
            )
            return {
                "name": "iupac_N_expected_barcodes_17B+T_16samples",
                "level": "e2e",
                "reads_per_sec": round(iu_rps, 1),
                "proxy_reads_per_sec": round(proxy_iu, 1) if proxy_iu else None,
                "vs_config_baseline": round(iu_rps / proxy_iu, 2) if proxy_iu else None,
                "host_speed_of_light": host_speed_of_light(
                    iu_rps, N_READS_SECONDARY, iu_t, inputs=[iu_path]
                ),
            }

        guarded("iupac_N_expected_barcodes_17B+T_16samples", bench_iupac_config)

        # ---- config 5: variable-length '+' structures, PE (headline shape) ----
        def bench_varlen_config():
            v1, _ = write_single_end_inputs(
                tmp, [b[:BC1] for b in barcodes], N_READS_SECONDARY, "v1",
                var_template=True,
            )
            v2, _ = write_single_end_inputs(
                tmp, [b[BC1:] for b in barcodes], N_READS_SECONDARY, "v2",
                var_template=True,
            )
            var_rps, var_t, proxy_var = run_config_ab(
                tmp, [v1, v2], ["8B+T", "9B+T"], meta, barcodes,
                N_READS_SECONDARY, "var", trials=3,
            )
            return {
                "name": "variable_length_plus_structures_PE_96samples",
                "level": "e2e",
                "reads_per_sec": round(var_rps, 1),
                "proxy_reads_per_sec": round(proxy_var, 1) if proxy_var else None,
                "vs_config_baseline": round(var_rps / proxy_var, 2) if proxy_var else None,
                "host_speed_of_light": host_speed_of_light(
                    var_rps, N_READS_SECONDARY, var_t, inputs=[v1, v2]
                ),
                "note": "multi-host streaming validated separately "
                "(tests/test_multiprocess.py on a 2-process jax.distributed run)",
            }

        guarded("variable_length_plus_structures_PE_96samples", bench_varlen_config)

        # ---- config 4: 737K single-cell whitelist (matcher-level) ----
        guarded("single_cell_737K_whitelist_16B", bench_bigk_config)

        # ---- mid-K: the device matcher ----
        guarded("mid_K_8192_16bp_mm1_d2", bench_midk_config)

        # ---- subsample: the other half of the CLI surface ----
        guarded("subsample_PE_fraction0.3", bench_subsample_config, tmp, paths)

    baseline_rps, baseline_note = rust_baseline()
    full = {
        "metric": "demux_e2e_reads_per_sec",
        "value": round(e2e_rps, 1),
        "unit": "reads/s",
        # vs_baseline is the CONTROLLED comparison: product and
        # reference-architecture proxy measured back-to-back on the
        # same inputs in the same noise window (this VM has ~2x
        # noisy-neighbor phases lasting tens of minutes, so ratios
        # against numbers from other windows are not meaningful).
        # The best-ever-observed pinned proxy is kept alongside.
        "vs_baseline": round(e2e_rps / proxy_di, 4)
        if proxy_di
        else round(e2e_rps / baseline_rps, 4),
        "vs_pinned_best_proxy": round(e2e_rps / baseline_rps, 4),
        "device": device,
        "kernel_assign_reads_per_sec": round(kernel_rps, 1),
        "kernel_device": kernel_device,
        "stage_seconds": stage_timings,
        "config": "dual-index PE, 96 samples, 8B+9B, max_mm=1, delta=2, native engine",
        "baseline_note": baseline_note,
        "configs": configs,
    }
    print(json.dumps(full))
    # The tail of a long output can lose the big line's headline fields:
    # re-print a compact headline-last summary.
    print(
        json.dumps(
            {
                "metric": "demux_e2e_reads_per_sec",
                "headline_reads_per_sec": full["value"],
                "unit": "reads/s",
                "vs_baseline": full["vs_baseline"],
                "configs_vs_baseline": {
                    c["name"]: c.get("vs_config_baseline")
                    for c in configs
                },
                "value": full["value"],
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
