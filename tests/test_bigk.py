"""Big-K pigeonhole matcher: differential fuzz vs the NumPy executable spec.

The C++ ``BigKMatcher`` (exact-candidate filtering over part-indexed CSR
tables) must agree with ``assign_batch_np`` — the validated spec of the
reference's ``BarcodeMatcher::assign`` — on every read, including ties,
no-calls, IUPAC observed bases, and U/lowercase canonicalization.
"""

import numpy as np
import pytest

from fqtk_tpu.core.encoding import ENCODE_LUT
from fqtk_tpu.io import native as native_io
from fqtk_tpu.ops.matcher import ExpectedSet, assign_batch_np

pytestmark = pytest.mark.skipif(
    not native_io.available(), reason="native library unavailable"
)


def _pack(obs: np.ndarray) -> np.ndarray:
    masks = ENCODE_LUT[obs].astype(np.uint8)
    n, length = masks.shape
    if length % 2:
        masks = np.concatenate(
            [masks, np.zeros((n, 1), dtype=np.uint8)], axis=1
        )
    return (masks[:, 0::2] | (masks[:, 1::2] << 4)).astype(np.uint8)


def _whitelist(rng, k, length):
    out, seen = [], set()
    while len(out) < k:
        b = "".join(rng.choice(list("ACGT"), size=length))
        if b not in seen:
            seen.add(b)
            out.append(b)
    return out


@pytest.mark.parametrize(
    "max_mm,delta,length,k",
    [(1, 2, 16, 300), (0, 2, 12, 200), (2, 1, 17, 257), (1, 0, 10, 64), (2, 3, 16, 128)],
)
def test_bigk_matches_numpy_spec(max_mm, delta, length, k):
    rng = np.random.default_rng(100 + max_mm * 10 + delta)
    barcodes = _whitelist(rng, k, length)
    expected = ExpectedSet.from_barcodes(barcodes)
    m = native_io.NativeBigKMatcher(barcodes, max_mm, delta, threads=3)

    n = 4000
    obs_rows = []
    weird = np.frombuffer(b"NRYacgtU.", dtype=np.uint8)
    for i in range(n):
        base = list(barcodes[int(rng.integers(0, k))].encode())
        n_mut = int(rng.integers(0, max_mm + delta + 2))
        for _ in range(n_mut):
            pos = int(rng.integers(0, length))
            if rng.integers(0, 3) == 0:
                base[pos] = int(weird[int(rng.integers(0, len(weird)))])
            else:
                base[pos] = ord("ACGT"[int(rng.integers(0, 4))])
        obs_rows.append(bytes(base))
    obs = np.frombuffer(b"".join(obs_rows), dtype=np.uint8).reshape(n, length)

    got = m.assign(_pack(obs))
    want, _, _ = assign_batch_np(obs, expected, max_mm, delta)
    want = np.where(want < 0, k, want).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    m.close()


def test_bigk_tie_break_first_index():
    # two barcodes equidistant from the read: strict-< semantics reject via
    # the delta gate; with delta=0 the LOWER index wins
    barcodes = ["AAAAAAAA", "AAAAAAAT", "TTTTTTTT"]
    obs = np.frombuffer(b"AAAAAAAC", dtype=np.uint8).reshape(1, 8)
    m = native_io.NativeBigKMatcher(barcodes, 1, 0, threads=1)
    got = m.assign(_pack(obs))
    assert got[0] == 0  # both idx 0 and 1 at mm=1; first index wins
    m.close()
    m2 = native_io.NativeBigKMatcher(barcodes, 1, 1, threads=1)
    got2 = m2.assign(_pack(obs))
    assert got2[0] == 3  # delta gate: next - best == 0 < 1 -> unmatched
    m2.close()


def test_bigk_nocall_prefilter():
    barcodes = ["ACGTACGT", "TGCATGCA"]
    m = native_io.NativeBigKMatcher(barcodes, 1, 2, threads=1)
    obs = np.frombuffer(b"NNGTACGT", dtype=np.uint8).reshape(1, 8)
    # 2 no-calls > max_mm + max_ns(0) -> unmatched even though mm would be 2
    assert m.assign(_pack(obs))[0] == 2
    obs1 = np.frombuffer(b"NCGTACGT", dtype=np.uint8).reshape(1, 8)
    assert m.assign(_pack(obs1))[0] == 0  # 1 no-call allowed, mm=1
    m.close()


def test_bigk_accepts_iupac_whitelist():
    # degenerate whitelists are pigeonhole-eligible via expanded tables;
    # the N position accepts any read base (containment semantics)
    m = native_io.NativeBigKMatcher(["ACGN", "TTTT"], 1, 2, threads=1)
    obs = np.frombuffer(b"ACGC", dtype=np.uint8).reshape(1, 4)
    assert m.assign(_pack(obs))[0] == 0  # C inside N: zero mismatches
    m.close()


def test_bigk_rejects_invalid_whitelist_bytes():
    with pytest.raises(native_io.NativeDemuxError):
        native_io.NativeBigKMatcher(["ACGX", "ACGT"], 1, 2)


def test_bigk_u_matches_t():
    barcodes = ["ACGTACGT", "GGGGCCCC"]
    m = native_io.NativeBigKMatcher(barcodes, 0, 2, threads=1)
    obs = np.frombuffer(b"ACGUACGU", dtype=np.uint8).reshape(1, 8)
    assert m.assign(_pack(obs))[0] == 0  # U encodes as T: exact match
    m.close()


def test_pigeonhole_selected_in_driver_matches_numpy_engine(tmp_path, monkeypatch):
    """Lower the big-K threshold so run_demux auto-selects the pigeonhole
    matcher, and verify byte-identical outputs vs the numpy engine."""
    import gzip

    from fqtk_tpu.runtime import demux as demux_mod
    from fqtk_tpu.runtime.demux import DemuxConfig, run_demux

    monkeypatch.setattr(demux_mod, "BIG_K_THRESHOLD", 16)
    rng = np.random.default_rng(3)
    barcodes = _whitelist(rng, 48, 12)
    meta = tmp_path / "metadata.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"S{i:03d}\t{b}\n" for i, b in enumerate(barcodes))
    )
    i1 = tmp_path / "in.fq.gz"
    with gzip.open(i1, "wb") as fh:
        for r in range(150):
            bc = list(barcodes[int(rng.integers(0, 48))])
            if rng.integers(0, 3) == 0:
                bc[int(rng.integers(0, 12))] = "ACGTN"[int(rng.integers(0, 5))]
            fh.write(
                b"@q%d 1:N:0:0\n%sACGTAC\n+\n%s\n"
                % (r, "".join(bc).encode(), b"I" * 18)
            )

    def cfg(out, engine, devices=1):
        return DemuxConfig(
            inputs=[i1],
            read_structures=["12B+T"],
            sample_metadata=meta,
            output=tmp_path / out,
            batch_size=32,
            engine=engine,
            devices=devices,
        )

    res_n = run_demux(cfg("out_native", "native"))
    monkeypatch.setattr(demux_mod, "BIG_K_THRESHOLD", 1 << 30)
    res_p = run_demux(cfg("out_numpy", "numpy"))
    assert res_n.total_templates == res_p.total_templates == 150
    for p in sorted((tmp_path / "out_numpy").glob("*.fq.gz")):
        a = gzip.decompress(p.read_bytes())
        b = gzip.decompress((tmp_path / "out_native" / p.name).read_bytes())
        assert a == b, p.name
    assert (tmp_path / "out_native" / "demux-metrics.txt").read_text() == (
        tmp_path / "out_numpy" / "demux-metrics.txt"
    ).read_text()


def test_bigk_rejects_oversized_part_key_space():
    """Configurations whose parts exceed the dense-table bound (4^12 keys)
    are ineligible rather than undefined: mm=0, delta=1 makes ONE part of
    the full 16bp barcode (4^16 keys — previously an out-of-bounds write)."""
    barcodes = ["ACGTACGTACGTACGT", "TGCATGCATGCATGCA"]
    with pytest.raises(native_io.NativeDemuxError):
        native_io.NativeBigKMatcher(barcodes, 0, 1)
    # boundary: 12-symbol parts are allowed (mm=0, delta=1, len=12)
    m = native_io.NativeBigKMatcher(["ACGTACGTACGT", "TGCATGCATGCA"], 0, 1)
    obs = np.frombuffer(b"ACGTACGTACGT", dtype=np.uint8).reshape(1, 12)
    assert m.assign(_pack(obs))[0] == 0
    m.close()


def test_assign_fn_cache_respects_batch_size(tmp_path, monkeypatch):
    """Regression: the assign-fn memo must key on batch_size — a mesh fn
    built for a divisible batch must not be reused for an indivisible one
    (shard_map would raise mid-demux)."""
    import gzip

    import jax

    if jax.local_device_count() < 2:
        pytest.skip("needs multiple devices")
    from fqtk_tpu.runtime.demux import DemuxConfig, run_demux

    rng = np.random.default_rng(9)
    barcodes = _whitelist(rng, 8, 8)
    meta = tmp_path / "m.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"S{i}\t{b}\n" for i, b in enumerate(barcodes))
    )
    p = tmp_path / "in.fq.gz"
    with gzip.open(p, "wb") as fh:
        for i in range(30):
            fh.write(b"@q%d\n%sAC\n+\nIIIIIIIIII\n" % (i, barcodes[i % 8].encode()))

    def cfg(out, batch):
        return DemuxConfig(
            inputs=[p],
            read_structures=["8B+T"],
            sample_metadata=meta,
            output=tmp_path / out,
            batch_size=batch,
            engine="native",
            devices=None,
        )

    r1 = run_demux(cfg("o1", 16))  # divisible by 8 -> mesh fn cached
    r2 = run_demux(cfg("o2", 7))  # indivisible -> must NOT reuse the mesh fn
    assert r1.total_templates == r2.total_templates == 30


def test_bigk_wildcard_bytes_match_spec():
    """Invalid read bytes (IUPAC mask 0, e.g. 'X') are spec-level wildcards:
    ``obs & ~exp == 0`` against every expected mask, so they never mismatch
    (reference ``bitenc.rs:441`` with a zero observed nibble).  The
    pigeonhole tables must still find candidates through parts containing
    them (regression: such parts used to be skipped entirely, losing the
    true best match)."""
    rng = np.random.default_rng(77)
    k, length = 1000, 16
    barcodes = _whitelist(rng, k, length)
    expected = ExpectedSet.from_barcodes(barcodes)

    # read = barcode 7 with a wildcard in part 0 and a mismatch in part 1:
    # the only zero-mismatch part is the one holding the wildcard
    read = bytearray(barcodes[7].encode())
    read[0] = ord("X")
    read[8] = ord("ACGT"[(("ACGT".index(chr(read[8]))) + 1) % 4])
    obs = np.frombuffer(bytes(read), dtype=np.uint8).reshape(1, length)
    want, _, _ = assign_batch_np(obs, expected, 1, 1)
    assert want[0] == 7  # the spec finds it
    m = native_io.NativeBigKMatcher(barcodes, 1, 1, threads=1)
    assert m.assign(_pack(obs))[0] == 7
    m.close()


@pytest.mark.parametrize("max_mm,delta", [(1, 2), (2, 1), (1, 1), (2, 3)])
def test_bigk_invalid_byte_fuzz_matches_spec(max_mm, delta):
    """Differential fuzz with invalid bytes ('X', '-', '@', lowercase 'x')
    mixed into the reads, including all-wildcard storm rows that force the
    full-scan fallback."""
    rng = np.random.default_rng(500 + max_mm * 10 + delta)
    k, length = 500, 16
    barcodes = _whitelist(rng, k, length)
    expected = ExpectedSet.from_barcodes(barcodes)
    n = 2000
    obs = np.frombuffer(
        "".join(barcodes[int(i)] for i in rng.integers(0, k, size=n)).encode(),
        dtype=np.uint8,
    ).reshape(n, length).copy()
    for frac, chars in ((0.3, b"ACGT"), (0.1, b"Nn."), (0.08, b"RYX-x@")):
        rows = rng.integers(0, n, size=int(n * frac))
        cols = rng.integers(0, length, size=len(rows))
        pick = np.frombuffer(bytes(chars), dtype=np.uint8)
        obs[rows, cols] = pick[rng.integers(0, len(pick), size=len(rows))]
    obs[0] = ord("X")  # wildcard storm: > kMaxWildPerPart, full-scan path
    obs[1, :8] = ord("-")

    m = native_io.NativeBigKMatcher(barcodes, max_mm, delta, threads=3)
    got = m.assign(_pack(obs))
    want, _, _ = assign_batch_np(obs, expected, max_mm, delta)
    want = np.where(want < 0, k, want).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    m.close()


def _iupac_whitelist(rng, k, length, frac_degenerate=0.08, n_storm_rows=3):
    """Whitelist with degenerate IUPAC positions; the first rows are
    mostly-N (expansion blowup -> always-candidate list)."""
    iupac = "ACGTMRWSYKVHDBN"
    out, seen = [], set()
    while len(out) < k:
        r = [
            iupac[int(rng.integers(0, len(iupac)))]
            if rng.random() < frac_degenerate
            else "ACGT"[int(rng.integers(0, 4))]
            for _ in range(length)
        ]
        if len(out) < n_storm_rows:
            r = ["N"] * min(10, length - 1) + r[min(10, length - 1):]
        s = "".join(r)
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


@pytest.mark.parametrize("max_mm,delta", [(1, 2), (2, 1), (1, 1), (0, 2)])
def test_bigk_iupac_whitelist_matches_spec(max_mm, delta):
    """Degenerate (IUPAC) whitelists now take the pigeonhole path via
    expanded tables: each barcode is inserted under every part key its
    masks accept, candidates score with 4-bit-mask containment, and
    barcodes too degenerate to enumerate go on an always-scanned list.
    Differential vs the NumPy spec over reads with mutations, no-calls,
    IUPAC observed bases, and wildcard bytes."""
    rng = np.random.default_rng(900 + max_mm * 10 + delta)
    k, length = 800, 16
    barcodes = _iupac_whitelist(rng, k, length)
    expected = ExpectedSet.from_barcodes(barcodes)
    assert expected.max_ns_in_barcodes > 0  # the N budget is exercised

    n = 3000
    obs = np.empty((n, length), dtype=np.uint8)
    from fqtk_tpu.core.encoding import ENCODE_LUT as _LUT

    for i in range(n):
        src = barcodes[int(rng.integers(0, k))]
        row = []
        for ch in src:
            m = int(_LUT[ord(ch)])
            opts = [b for b in "ACGT" if (m >> "ACGT".index(b)) & 1]
            row.append(
                opts[int(rng.integers(0, len(opts)))]
                if rng.random() < 0.9
                else ch
            )
        obs[i] = np.frombuffer("".join(row).encode(), dtype=np.uint8)
    for frac, chars in ((0.25, b"ACGT"), (0.08, b"Nn."), (0.05, b"RYX-")):
        sel = rng.integers(0, n, size=int(n * frac))
        cols = rng.integers(0, length, size=len(sel))
        pick = np.frombuffer(bytes(chars), dtype=np.uint8)
        obs[sel, cols] = pick[rng.integers(0, len(pick), size=len(sel))]
    obs[0] = ord("X")  # wildcard storm -> full-scan fallback

    m = native_io.NativeBigKMatcher(barcodes, max_mm, delta, threads=3)
    got = m.assign(_pack(obs))
    want, _, _ = assign_batch_np(obs, expected, max_mm, delta)
    want = np.where(want < 0, k, want).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    m.close()


def test_bigk_iupac_nocall_budget():
    """The no-call prefilter uses max_mm + max_ns_in_barcodes (reference
    barcode_matching.rs:170-172) — an N in the whitelist raises the read's
    allowed no-call count."""
    barcodes = ["ACGTACGN", "TGCATGCA"]
    m = native_io.NativeBigKMatcher(barcodes, 1, 2, threads=1)
    # 2 no-calls <= max_mm(1) + max_ns(1): eligible; the N over the
    # expected-N position costs 0 mismatches, the other costs 1 -> match.
    # (With a max_mm-only budget this read would be wrongly prefiltered.)
    obs = np.frombuffer(b"NCGTACGN", dtype=np.uint8).reshape(1, 8)
    assert m.assign(_pack(obs))[0] == 0
    # 3 no-calls > budget: unmatched
    obs2 = np.frombuffer(b"NCGNACGN", dtype=np.uint8).reshape(1, 8)
    assert m.assign(_pack(obs2))[0] == 2
    m.close()


@pytest.mark.parametrize("iupac", [False, True])
def test_bigk_memo_cache_transparent(monkeypatch, iupac):
    """The per-thread memo cache must be invisible on the big-K paths:
    repeat-heavy reads (the single-cell distribution: thousands of reads
    per cell barcode) through one matcher across several batches agree
    with a cache-disabled matcher and the NumPy spec, for both the pure
    fused path and the degenerate expanded-table path."""
    rng = np.random.default_rng(777 + iupac)
    k, length = 3000, 16
    barcodes = _whitelist(rng, k, length)
    if iupac:
        barcodes = [
            b[:7] + "N" + b[8:] if i % 5 == 0 else b
            for i, b in enumerate(barcodes)
        ]
    expected = ExpectedSet.from_barcodes(barcodes)
    # ~40 "cells", heavy repetition + mutants + no-calls
    cells = [barcodes[int(rng.integers(0, k))] for _ in range(40)]
    pool = np.frombuffer(
        "".join(cells[int(rng.integers(0, 40))] for _ in range(400)).encode(),
        dtype=np.uint8,
    ).reshape(400, length).copy()
    sel = rng.integers(0, 400, size=120)
    pool[sel, rng.integers(0, length, size=120)] = np.frombuffer(
        b"ACGTN", dtype=np.uint8
    )[rng.integers(0, 5, size=120)]
    obs = pool[rng.integers(0, 400, size=6000)]
    m = native_io.NativeBigKMatcher(barcodes, 1, 2, threads=3)
    monkeypatch.setenv("FQTK_BIGK_NO_CACHE", "1")
    m_off = native_io.NativeBigKMatcher(barcodes, 1, 2, threads=3)
    monkeypatch.delenv("FQTK_BIGK_NO_CACHE")
    want, _, _ = assign_batch_np(obs, expected, 1, 2)
    want = np.where(want < 0, k, want).astype(np.int32)
    for lo in range(0, len(obs), 2048):  # several batches, warm cache
        chunk = obs[lo : lo + 2048]
        got = m.assign(_pack(chunk))
        np.testing.assert_array_equal(got, want[lo : lo + 2048])
        np.testing.assert_array_equal(got, m_off.assign(_pack(chunk)))
    m.close()
    m_off.close()


def test_bigk_dot_whitelist_nocall_budget():
    """'.' in an expected barcode is a no-call byte (mod.rs:85-87) and must
    raise the read-side no-call budget exactly like 'N' does."""
    barcodes = ["ACGTACG.", "TGCATGCA"]
    m = native_io.NativeBigKMatcher(barcodes, 1, 2, threads=1)
    obs = np.frombuffer(b"NCGTACGN", dtype=np.uint8).reshape(1, 8)
    assert m.assign(_pack(obs))[0] == 0  # budget 1+1=2 admits both no-calls
    obs2 = np.frombuffer(b"NCGNACGN", dtype=np.uint8).reshape(1, 8)
    assert m.assign(_pack(obs2))[0] == 2  # 3 no-calls > budget
    m.close()


def test_bigk_iupac_longer_than_16_falls_back():
    """Degenerate whitelists beyond 16bp exceed the single-u64 4-bit
    packing and stay on the device path."""
    with pytest.raises(native_io.NativeDemuxError):
        native_io.NativeBigKMatcher(["ACGTACGTACGTACGTN", "TGCATGCATGCATGCAA"], 1, 2)


@pytest.mark.parametrize("level", ["scalar", "avx2", "avx512"])
def test_bigk_simd_dispatch_levels_agree(level, monkeypatch):
    """Every SIMD dispatch level of the candidate scans (FQTK_SIMD caps the
    runtime avx512bw > avx2 > scalar choice) must produce assignments
    identical to the NumPy spec — an avx512 host otherwise never executes
    the avx2 variants at all.  Covers both the pure-ACGT fused scan and the
    degenerate-IUPAC containment scan."""
    monkeypatch.setenv("FQTK_SIMD", level)
    monkeypatch.setenv("FQTK_BIGK_NO_CACHE", "1")  # isolate the scans
    # the cap must actually bite (a typo'd FQTK_SIMD value silently running
    # the full dispatch is exactly the failure this test exists to prevent)
    cap = {"scalar": 0, "avx2": 1, "avx512": 2}[level]
    assert native_io.simd_level() <= cap
    rng = np.random.default_rng(777)
    k, length = 400, 16
    barcodes = _whitelist(rng, k, length)
    # degenerate variant: one N per barcode exercises the iupac scan
    bc_iupac = [b[:7] + "N" + b[8:] for b in barcodes]

    n = 3000
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    obs = np.frombuffer(
        b"".join(barcodes[int(c)].encode() for c in rng.integers(0, k, size=n)),
        dtype=np.uint8,
    ).reshape(n, length).copy()
    mut = rng.integers(0, 3, size=n) == 0
    obs[mut, rng.integers(0, length, size=n)[mut]] = letters[
        rng.integers(0, 4, size=int(mut.sum()))
    ]
    obs[:8] = np.frombuffer(b"N" * length, dtype=np.uint8)  # no-call rows

    for bcs in (barcodes, bc_iupac):
        expected = ExpectedSet.from_barcodes(bcs)
        m = native_io.NativeBigKMatcher(bcs, 1, 2, threads=2)
        got = m.assign(_pack(obs))
        m.close()
        want, _, _ = assign_batch_np(obs, expected, 1, 2)
        want = np.where(want < 0, k, want).astype(np.int32)
        np.testing.assert_array_equal(got, want)


def test_matcher_constructors_validate_whitelist_shape():
    """Empty and unequal-length whitelists get clean errors, not an
    IndexError or silent row mis-framing of the concatenated buffer."""
    for cls in (native_io.NativeBigKMatcher, native_io.NativeSmallKMatcher):
        with pytest.raises(native_io.NativeDemuxError, match="at least one"):
            cls([], 1, 2)
        with pytest.raises(native_io.NativeDemuxError, match="same length"):
            cls(["ACGT", "ACGTA"], 1, 2)
