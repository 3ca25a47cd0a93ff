"""Fused Triton top-2 matcher tests (Pallas interpreter on the CPU; the
compiled kernel is checked on the card by ``chip_smoke.py``)."""

import numpy as np
import pytest

from fqtk_tpu.ops.matcher import MAX_COUNT, ExpectedSet, assign_batch_np

from .util import pack_bit2, pack_nib4

jax = pytest.importorskip("jax")

from fqtk_tpu.ops.pallas_matcher import (  # noqa: E402
    compat_for_plan,
    make_pallas_assign_fn,
    plan_local_kernel,
)


def _case(rng, k, length, b, alphabet=b"ACGTN"):
    bases = np.frombuffer(alphabet, dtype=np.uint8)
    barcodes = set()
    while len(barcodes) < k:
        barcodes.add(bytes(rng.choice(bases, size=length)).decode())
    barcodes = sorted(barcodes)
    es = ExpectedSet.from_barcodes(barcodes)
    obs = rng.choice(bases, size=(b, length)).astype(np.uint8)
    for i in range(0, b, 4):
        obs[i] = np.frombuffer(barcodes[i % k].encode(), dtype=np.uint8)
    return es, obs


def _check(fn, packed, obs, es, mm, delta):
    idx, best, nxt = (np.asarray(x) for x in fn(packed))
    np_idx, np_best, np_next = assign_batch_np(obs, es, mm, delta)
    np.testing.assert_array_equal(
        idx.astype(np.int32), np.where(np_idx < 0, es.count, np_idx)
    )
    np.testing.assert_array_equal(best, np_best)
    np.testing.assert_array_equal(nxt, np_next)


def _run(es, obs, mm, delta, packing, **kw):
    if packing == "bit2":
        packed = pack_bit2(obs)
    else:
        packed = pack_nib4(obs)
    fn = make_pallas_assign_fn(
        es, mm, delta, packed2=packing == "bit2", interpret=True, **kw
    )
    _check(fn, packed, obs, es, mm, delta)
    return fn


@pytest.mark.parametrize("mm,delta", [(1, 2), (0, 0), (2, 1)])
@pytest.mark.parametrize("tile_b,tile_k", [(16, 32), (64, 128)])
@pytest.mark.parametrize("packing", ["bit2", "nib4"])
def test_pallas_matches_numpy(packing, tile_b, tile_k, mm, delta):
    """Block sizes x packings x gates; K=43 spans two 32-column tiles."""
    rng = np.random.default_rng(7)
    alphabet = b"ACGT" if packing == "bit2" else b"ACGTN"
    es, obs = _case(rng, k=43, length=11, b=128, alphabet=alphabet)
    _run(es, obs, mm, delta, packing, tile_b=tile_b, tile_k=tile_k)


def test_pallas_multiple_k_tiles_tie_break():
    """Equidistant barcodes in different K tiles: the first index wins."""
    cg = [format(i, "08b").replace("0", "C").replace("1", "G") for i in range(32)]
    barcodes = ["AAAAAAAA"] + cg + ["AAAAAATT"]
    es = ExpectedSet.from_barcodes(barcodes)
    # 1 mismatch from barcode 0 (tile 0) and from the last one (tile 1)
    obs = np.frombuffer(b"AAAAAAAT", dtype=np.uint8)[None, :].repeat(32, 0)
    fn = _run(es, obs, 8, 0, "bit2", tile_b=16, tile_k=32)
    assert fn.plan.n_k_tiles == 2
    idx, best, nxt = (np.asarray(x) for x in fn(pack_bit2(obs)))
    assert (idx == 0).all() and (best == 1).all() and (nxt == 1).all()


@pytest.mark.parametrize("tile_k", [32, 64, 128])
def test_pallas_cross_tile_ties(tile_k):
    """Duplicated barcodes in different K tiles force best-count ties across
    the running merge; the first global index must win everywhere."""
    rng = np.random.default_rng(23)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seqs = rng.choice(bases, size=(300, 12)).astype(np.uint8)
    seqs[150] = seqs[3]
    seqs[299] = seqs[0]
    es = ExpectedSet.from_barcodes([bytes(r).decode() for r in seqs])
    obs = rng.choice(bases, size=(96, 12)).astype(np.uint8)
    obs[:48] = seqs[[0, 3, 150, 299] * 12]
    _run(es, obs, 2, 1, "bit2", tile_b=32, tile_k=tile_k)


def test_pallas_iupac_and_nocall_gates():
    """nib4 input: IUPAC containment, lowercase, and the no-call gate."""
    es = ExpectedSet.from_barcodes(["NNAAAAAA", "NNCCCCCC"])
    reads = [b"ANAAAAAA", b"ANCCCCCC", b"NNNAAAAA", b"anaaaaaa"]
    obs = np.tile(np.stack([np.frombuffer(r, dtype=np.uint8) for r in reads]), (4, 1))
    fn = _run(es, obs, 0, 0, "nib4", tile_b=16, tile_k=32)
    idx, _, _ = (np.asarray(x) for x in fn(pack_nib4(obs)))
    assert list(idx[:4]) == [0, 1, 2, 0]  # lowercase read matches too


@pytest.mark.parametrize("packing", ["bit2", "nib4"])
def test_pallas_single_barcode_next_is_maxcount(packing):
    """K == 1: next must be MAX_COUNT (numpy spec) though the kernel's pad
    columns report count L."""
    es = ExpectedSet.from_barcodes(["ACGTACGT"])
    obs = np.frombuffer(b"ACGTACGTACGTACGAACGTTCGT", dtype=np.uint8).reshape(3, 8)
    obs = np.tile(obs, (11, 1))[:32]
    fn = _run(es, obs, 1, 4, packing, tile_b=16, tile_k=32)
    assert fn.plan.k_padded == 32
    _, _, nxt = (np.asarray(x) for x in fn(pack_bit2(obs) if packing == "bit2" else pack_nib4(obs)))
    assert (nxt == MAX_COUNT).all()


def test_pallas_packed2_matches_numpy():
    """bit2 reads against an IUPAC whitelist (N and R expected bases)."""
    rng = np.random.default_rng(17)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    barcodes = set()
    while len(barcodes) < 37:
        barcodes.add(bytes(rng.choice(bases, size=9)).decode())
    barcodes = sorted(barcodes)
    barcodes[3] = barcodes[3][:4] + "N" + barcodes[3][5:]
    barcodes[7] = "R" + barcodes[7][1:]
    es = ExpectedSet.from_barcodes(barcodes)
    obs = rng.choice(bases, size=(100, 9)).astype(np.uint8)
    for i in range(0, 100, 3):
        bc = barcodes[i % 37].replace("N", "G").replace("R", "A")
        obs[i] = np.frombuffer(bc.encode(), dtype=np.uint8)
    fn = _run(es, obs, 1, 2, "bit2", tile_b=32, tile_k=32, compact_output=True)
    assert np.asarray(fn(pack_bit2(obs))[0]).dtype == np.uint8


@pytest.mark.parametrize("packing", ["bit2", "nib4"])
def test_pallas_wl_padding_length17(packing):
    """L=17: the one-hot width W*L (68 or 272) pads to a power of two, and
    the packed row (5 or 9 bytes) has a partial last byte."""
    rng = np.random.default_rng(5)
    alphabet = b"ACGT" if packing == "bit2" else b"ACGTN"
    es, obs = _case(rng, k=50, length=17, b=48, alphabet=alphabet)
    fn = _run(es, obs, 1, 2, packing, tile_b=16, tile_k=32)
    assert fn.plan.wl_padded == (128 if packing == "bit2" else 512)


@pytest.mark.parametrize("b", [1, 15, 17, 40])
def test_pallas_batch_not_block_multiple(b):
    """Any batch works: rows pad to a tile_b multiple and slice back."""
    rng = np.random.default_rng(b)
    es, obs = _case(rng, k=20, length=10, b=b, alphabet=b"ACGT")
    _run(es, obs, 1, 2, "bit2", tile_b=16, tile_k=32)


def test_pallas_packed_masks_and_compact_output():
    rng = np.random.default_rng(3)
    es, obs = _case(rng, k=29, length=9, b=40)  # odd length + non-tile b
    fn = _run(es, obs, 1, 2, "nib4", tile_b=16, tile_k=32, compact_output=True)
    assert np.asarray(fn(pack_nib4(obs))[0]).dtype == np.uint8


def test_plan_tiling_and_rejections():
    plan = plan_local_kernel(96, 17, packed2=True)
    assert (plan.tile_b, plan.tile_k, plan.n_k_tiles) == (256, 64, 2)
    assert plan.key_s1 * plan.key_s2 == plan.tile_k
    assert max(plan.key_s1, plan.key_s2) <= 127  # int8 operands
    big = plan_local_kernel(737_280, 16, packed2=True, tile_k=64)
    assert big.k_padded == 737_280 and big.n_k_tiles == 11_520
    assert plan_local_kernel(1 << 20, 16, True, tile_k=8192).tile_k == 4096
    with pytest.raises(ValueError, match="255"):
        plan_local_kernel(10, 256, packed2=False)
    with pytest.raises(ValueError, match="power of two"):
        plan_local_kernel(10, 8, packed2=True, tile_b=100)


def test_compat_for_plan_layout():
    """Class-major rows c*L + l scaled by key_s2; pad columns mismatch at
    every real position; pad rows are zero."""
    es = ExpectedSet.from_barcodes(["ACG", "TTN"])
    plan = plan_local_kernel(2, 3, packed2=True)
    t = compat_for_plan(es.masks, plan) // plan.key_s2
    assert t.shape == (32, 32)
    # class 0 (A) at position 0: mismatches "TTN" only
    assert list(t[0 * 3 + 0, :2]) == [0, 1]
    # class 3 (T) at position 2: mismatches G, matches N
    assert list(t[3 * 3 + 2, :2]) == [1, 0]
    assert (t[:12, 2:] == 1).all() and (t[12:] == 0).all()
