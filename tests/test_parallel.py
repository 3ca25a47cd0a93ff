"""Multi-device sharding tests on the virtual 8-CPU-device mesh."""

import numpy as np
import pytest

from fqtk_tpu.ops.matcher import ExpectedSet, assign_batch_np

from .util import pack_bit2, pack_nib4

jax = pytest.importorskip("jax")


def _random_case(rng, k, length, b):
    bases = np.frombuffer(b"ACGTN", dtype=np.uint8)
    barcodes = set()
    while len(barcodes) < k:
        barcodes.add(bytes(rng.choice(bases, size=length)).decode())
    barcodes = sorted(barcodes)
    es = ExpectedSet.from_barcodes(barcodes)
    obs = rng.choice(bases, size=(b, length)).astype(np.uint8)
    for i in range(0, b, 3):
        obs[i] = np.frombuffer(barcodes[i % k].encode(), dtype=np.uint8)
    return es, obs


def test_eight_devices_visible():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_batch,n_k", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_assign_matches_numpy(n_batch, n_k):
    from fqtk_tpu.parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    rng = np.random.default_rng(0)
    es, obs = _random_case(rng, k=23, length=9, b=64)
    max_mm, delta = 1, 2
    mesh = make_demux_mesh(n_batch=n_batch, n_whitelist=n_k)
    fn = make_sharded_assign_fn(es, max_mm, delta, mesh, k_chunk=8)
    assigned, counts = fn(obs)
    assigned = np.asarray(assigned)
    counts = np.asarray(counts)

    np_idx, _, _ = assign_batch_np(obs, es, max_mm, delta)
    expect = np.where(np_idx < 0, es.count, np_idx)
    np.testing.assert_array_equal(assigned, expect)
    np.testing.assert_array_equal(counts, np.bincount(expect, minlength=es.count + 1))


def test_sharded_assign_large_k_sharded():
    """737K-style whitelist path at reduced scale: K not divisible by shards."""
    from fqtk_tpu.parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    rng = np.random.default_rng(1)
    es, obs = _random_case(rng, k=101, length=8, b=32)
    mesh = make_demux_mesh(n_batch=2, n_whitelist=4)
    fn = make_sharded_assign_fn(es, 2, 1, mesh, k_chunk=16)
    assigned, counts = fn(obs)
    np_idx, _, _ = assign_batch_np(obs, es, 2, 1)
    expect = np.where(np_idx < 0, es.count, np_idx)
    np.testing.assert_array_equal(np.asarray(assigned), expect)
    np.testing.assert_array_equal(
        np.asarray(counts), np.bincount(expect, minlength=es.count + 1)
    )


def test_first_index_tie_break_across_shards():
    """Equidistant barcodes in different K shards: earliest index must win."""
    from fqtk_tpu.parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    barcodes = ["AAAA", "CCCC", "GGGG", "TTTT", "AAAT", "CCCG", "GGGA", "TTTC"]
    es = ExpectedSet.from_barcodes(barcodes)
    # read equidistant (1 mm) from barcodes 0 and 4 (different shards when nk=4)
    obs = np.frombuffer(b"AAAG", dtype=np.uint8)[None, :].repeat(8, axis=0)
    mesh = make_demux_mesh(n_batch=2, n_whitelist=4)
    fn = make_sharded_assign_fn(es, 2, 0, mesh)
    assigned, _ = fn(obs)
    np_idx, best, nxt = assign_batch_np(obs, es, 2, 0)
    assert int(best[0]) == 1 and int(nxt[0]) == 1
    np.testing.assert_array_equal(np.asarray(assigned), np.zeros(8, dtype=np.int32))


@pytest.mark.parametrize("n_batch,n_k", [(4, 2), (2, 4), (1, 8)])
def test_sharded_pallas_kernel_matches_numpy(n_batch, n_k):
    """The per-shard fused kernel (interpreter) under shard_map over nib4
    input must agree with the NumPy spec, including the cross-shard ordered
    merge, the no-call gate and the batch padding/count adjustment."""
    from fqtk_tpu.parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    rng = np.random.default_rng(7)
    es, obs = _random_case(rng, k=23, length=9, b=50)  # odd B: forces padding
    mesh = make_demux_mesh(n_batch=n_batch, n_whitelist=n_k)
    fn = make_sharded_assign_fn(
        es, 1, 2, mesh, packed_masks=True, use_kernel=True, interpret=True
    )
    assert fn.use_kernel
    assigned, counts = fn(pack_nib4(obs))
    np_idx, _, _ = assign_batch_np(obs, es, 1, 2)
    expect = np.where(np_idx < 0, es.count, np_idx)
    np.testing.assert_array_equal(np.asarray(assigned), expect)
    np.testing.assert_array_equal(
        np.asarray(counts), np.bincount(expect, minlength=es.count + 1)
    )


def test_sharded_pallas_packed2_matches_numpy():
    """bit2 transfers through the K-sharded kernel path (the production
    multi-device big-K configuration, at reduced scale)."""
    from fqtk_tpu.parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    barcodes = set()
    while len(barcodes) < 101:
        barcodes.add(bytes(rng.choice(bases, size=12)).decode())
    barcodes = sorted(barcodes)
    barcodes[5] = barcodes[5][:6] + "N" + barcodes[5][7:]  # IUPAC whitelist ok
    es = ExpectedSet.from_barcodes(barcodes)
    obs = rng.choice(bases, size=(70, 12)).astype(np.uint8)
    for i in range(0, 70, 3):
        obs[i] = np.frombuffer(
            barcodes[i % 101].replace("N", "T").encode(), dtype=np.uint8
        )
    mesh = make_demux_mesh(n_batch=2, n_whitelist=4)
    fn = make_sharded_assign_fn(
        es, 2, 1, mesh, packed2=True, compact_output=True,
        with_counts=False, use_kernel=True, interpret=True,
    )
    assigned = np.asarray(fn(pack_bit2(obs)))
    assert assigned.dtype == np.uint8
    np_idx, _, _ = assign_batch_np(obs, es, 2, 1)
    np.testing.assert_array_equal(
        assigned.astype(np.int32), np.where(np_idx < 0, es.count, np_idx)
    )


def test_sharded_pallas_tie_break_and_k1():
    """First-index tie-break across shards and the K=1 next=MAX_COUNT
    normalization, both through the kernel's shard path."""
    from fqtk_tpu.parallel.mesh import make_demux_mesh, make_sharded_assign_fn

    barcodes = ["AAAA", "CCCC", "GGGG", "TTTT", "AAAT", "CCCG", "GGGA", "TTTC"]
    es = ExpectedSet.from_barcodes(barcodes)
    obs = np.frombuffer(b"AAAG", dtype=np.uint8)[None, :].repeat(8, axis=0)
    mesh = make_demux_mesh(n_batch=2, n_whitelist=4)
    fn = make_sharded_assign_fn(
        es, 2, 0, mesh, packed2=True, use_kernel=True, interpret=True
    )
    assigned, _ = fn(pack_bit2(obs))
    np.testing.assert_array_equal(
        np.asarray(assigned), np.zeros(8, dtype=np.int32)
    )

    es1 = ExpectedSet.from_barcodes(["ACGT"])
    obs1 = np.frombuffer(b"ACGTACGA", dtype=np.uint8).reshape(2, 4)
    fn1 = make_sharded_assign_fn(
        es1, 1, 2, mesh, packed2=True, use_kernel=True, interpret=True
    )
    assigned1, counts1 = fn1(pack_bit2(obs1))
    np_idx, _, _ = assign_batch_np(obs1, es1, 1, 2)
    expect1 = np.where(np_idx < 0, 1, np_idx)
    np.testing.assert_array_equal(np.asarray(assigned1), expect1)
    np.testing.assert_array_equal(
        np.asarray(counts1), np.bincount(expect1, minlength=2)
    )
