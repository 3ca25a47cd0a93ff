"""Multi-device demux through the PRODUCT driver (not just library fns).

``run_demux`` with the native engine and ``--devices 8`` shards the device
matcher over the 8 fake CPU devices (conftest).  Outputs must be
byte-identical to a single-device run: batch-axis sharding is pure data
parallelism, and whitelist sharding's cross-shard top-2 merge preserves the
reference's first-index tie-break.
"""

import gzip
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from fqtk_tpu.runtime import demux as demux_mod
from fqtk_tpu.runtime.demux import DemuxConfig, run_demux

from .util import metadata_file


def _write_inputs(tmp_path, n_reads=203, k=24, bc_len=9, seed=5):
    rng = np.random.default_rng(seed)
    bases = "ACGT"
    barcodes = []
    seen = set()
    while len(barcodes) < k:
        b = "".join(rng.choice(list(bases), size=bc_len))
        if b not in seen:
            seen.add(b)
            barcodes.append(b)
    meta = metadata_file(tmp_path, barcodes)
    i1 = tmp_path / "i1.fq.gz"
    r1 = tmp_path / "r1.fq.gz"
    with gzip.open(i1, "wb") as f1, gzip.open(r1, "wb") as f2:
        for i in range(n_reads):
            bc = list(barcodes[int(rng.integers(0, k))])
            if rng.integers(0, 4) == 0:  # mutate one base
                pos = int(rng.integers(0, bc_len))
                bc[pos] = bases[int(rng.integers(0, 4))]
            if rng.integers(0, 11) == 0:
                bc[int(rng.integers(0, bc_len))] = "N"
            bc = "".join(bc)
            head = f"@inst:1:AB:2:3:{i}:9 1:N:0:0".encode()
            f1.write(head + b"\n" + bc.encode() + b"\n+\n" + b"I" * bc_len + b"\n")
            tmpl = "".join(rng.choice(list(bases), size=40))
            f2.write(head + b"\n" + tmpl.encode() + b"\n+\n" + b"I" * 40 + b"\n")
    return [i1, r1], meta


def _run(tmp_path, inputs, meta, out_name, devices, batch_size=16):
    out = tmp_path / out_name
    cfg = DemuxConfig(
        inputs=inputs,
        read_structures=["9B", "+T"],
        sample_metadata=meta,
        output=out,
        max_mismatches=1,
        min_mismatch_delta=2,
        batch_size=batch_size,
        engine="native",
        devices=devices,
    )
    res = run_demux(cfg)
    return out, res


def _compare_outputs(out_a: Path, out_b: Path):
    files_a = sorted(p.name for p in out_a.glob("*.fq.gz"))
    files_b = sorted(p.name for p in out_b.glob("*.fq.gz"))
    assert files_a == files_b
    for name in files_a:
        da = gzip.decompress((out_a / name).read_bytes())
        db = gzip.decompress((out_b / name).read_bytes())
        assert da == db, f"{name} differs between mesh and single-device"
    assert (out_a / "demux-metrics.txt").read_text() == (
        out_b / "demux-metrics.txt"
    ).read_text()


def test_batch_sharded_mesh_matches_single_device(tmp_path):
    assert jax.local_device_count() == 8
    inputs, meta = _write_inputs(tmp_path)
    out1, res1 = _run(tmp_path, inputs, meta, "out_single", devices=1)
    out8, res8 = _run(tmp_path, inputs, meta, "out_mesh", devices=8)
    assert res1.total_templates == res8.total_templates == 203
    _compare_outputs(out8, out1)


def test_whitelist_sharded_mesh_matches_single_device(tmp_path, monkeypatch):
    """Force the big-K policy at a tiny K so the K-sharded path (cross-shard
    top-2 merge) runs through the product driver."""
    monkeypatch.setattr(demux_mod, "BIG_K_THRESHOLD", 8)
    inputs, meta = _write_inputs(tmp_path, seed=11)
    out8, res8 = _run(tmp_path, inputs, meta, "out_ksharded", devices=8)
    monkeypatch.setattr(demux_mod, "BIG_K_THRESHOLD", 1 << 30)
    out1, res1 = _run(tmp_path, inputs, meta, "out_single", devices=1)
    assert res1.total_templates == res8.total_templates == 203
    _compare_outputs(out8, out1)


def test_indivisible_batch_falls_back_to_single_device(tmp_path):
    inputs, meta = _write_inputs(tmp_path, n_reads=50, seed=7)
    out, res = _run(
        tmp_path, inputs, meta, "out_odd", devices=8, batch_size=7
    )
    assert res.total_templates == 50
    assert (out / "demux-metrics.txt").exists()
