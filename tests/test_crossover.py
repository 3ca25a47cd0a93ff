"""Measured matcher-placement (host vs device) crossover tests.

The auto policy must MEASURE the host-vs-device crossover instead of
trusting a constant tuned for one machine.  These tests fake the
probe timings (the real probe runs on accelerator backends only): a fast
device must flip auto to the device path, slow-dispatch timings must keep the
host path without ever building the device matcher, the decision must be
disk-cached and surfaced in DemuxResult.timings, and the explicit env cap
must still override everything.
"""

import gzip

import numpy as np
import pytest

from fqtk_tpu.io import native as native_io
from fqtk_tpu.runtime import demux as demux_mod
from fqtk_tpu.runtime.demux import DemuxConfig, run_demux

pytestmark = pytest.mark.skipif(
    not native_io.available(), reason="native library required"
)


def _barcodes(k, length, seed):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = set()
    while len(out) < k:
        out.add(bytes(rng.choice(bases, size=length)).decode())
    return sorted(out)


def _cfg(tmp_path, barcodes, **kw):
    meta = tmp_path / "meta.tsv"
    meta.write_text(
        "sample_id\tbarcode\n"
        + "".join(f"S{i}\t{b}\n" for i, b in enumerate(barcodes))
    )
    return DemuxConfig(
        inputs=[tmp_path / "in.fastq"],
        read_structures=[f"{len(barcodes[0])}B+T"],
        sample_metadata=meta,
        output=tmp_path / "out",
        batch_size=64,
        **kw,
    )


def _arm(monkeypatch, tmp_path, host_s, floor_s, device_s):
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    monkeypatch.setattr(
        demux_mod, "_CROSSOVER_CACHE_PATH", str(tmp_path / "crossover.json")
    )
    monkeypatch.setattr(demux_mod, "_probe_allowed", lambda: True)
    monkeypatch.setattr(
        demux_mod, "_time_host_window", lambda m, w, reps=2: host_s
    )
    monkeypatch.setattr(
        demux_mod, "_device_floor_seconds", lambda b, w, reps=2: floor_s
    )
    monkeypatch.setattr(
        demux_mod, "_time_device_window", lambda fn, ws: device_s
    )
    demux_mod._ASSIGN_FN_CACHE.clear()


def test_fast_device_flips_auto_to_device(monkeypatch, tmp_path):
    """A device that wins the measured A/B takes the auto placement even at
    a whitelist size the old static cap kept on the host."""
    _arm(monkeypatch, tmp_path, host_s=0.050, floor_s=0.0002, device_s=0.001)
    barcodes = _barcodes(40, 10, seed=1)
    from fqtk_tpu.ops.matcher import ExpectedSet

    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)
    assign, pack_mode, host_matcher = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert not host_matcher, "fast device must win the measured placement"
    info = getattr(assign, "crossover", {})
    assert info.get("crossover_device_chosen") == 1.0
    assert info.get("crossover_device_s") == pytest.approx(0.001)


def test_relay_like_floor_keeps_host_without_device_build(monkeypatch, tmp_path):
    """Slow-dispatch timings (fat device floor, quick host scan): host wins
    and the real device matcher is never built or compiled."""
    _arm(monkeypatch, tmp_path, host_s=0.003, floor_s=0.025, device_s=None)
    built = []
    real_build = demux_mod._build_device_side
    monkeypatch.setattr(
        demux_mod,
        "_build_device_side",
        lambda cfg, es: built.append(1) or real_build(cfg, es),
    )
    barcodes = _barcodes(37, 9, seed=2)
    from fqtk_tpu.ops.matcher import ExpectedSet

    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)
    assign, pack_mode, host_matcher = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert host_matcher and pack_mode == "nib4"
    assert not built, "host decision must skip the device matcher build"
    info = getattr(assign, "crossover", {})
    assert info.get("crossover_device_chosen") == 0.0
    assert info.get("crossover_host_s") == pytest.approx(0.003)

    # decision is disk-cached: a fresh call must not re-probe
    def boom(*a, **k):
        raise AssertionError("probe must not re-run on a cached decision")

    monkeypatch.setattr(demux_mod, "_time_host_window", boom)
    monkeypatch.setattr(demux_mod, "_device_floor_seconds", boom)
    demux_mod._ASSIGN_FN_CACHE.clear()
    assign2, _, host2 = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert host2


def test_decision_surfaces_in_demux_result_timings(monkeypatch, tmp_path):
    _arm(monkeypatch, tmp_path, host_s=0.002, floor_s=0.030, device_s=None)
    barcodes = _barcodes(20, 8, seed=3)
    src = tmp_path / "in.fastq"
    with open(src, "w") as fh:
        for i in range(40):
            fh.write(f"@q{i} 1:N:0:0\n{barcodes[i % 20]}ACGT\n+\n{';' * 12}\n")
    cfg = _cfg(tmp_path, barcodes, engine="native")
    res = run_demux(cfg)
    assert res.timings.get("crossover_device_chosen") == 0.0
    assert "crossover_host_s" in res.timings
    out = gzip.open(tmp_path / "out" / "S0.R1.fq.gz").read()
    assert out.count(b"@q") > 0


def test_env_cap_still_overrides(monkeypatch, tmp_path):
    """An explicit FQTK_HOST_MATCHER_MAX_K pins the crossover; the probe
    must not run at all."""

    def boom(*a, **k):
        raise AssertionError("probe must not run with an explicit cap")

    monkeypatch.setenv("FQTK_HOST_MATCHER_MAX_K", "100")
    monkeypatch.setattr(demux_mod, "_measured_placement", boom)
    demux_mod._ASSIGN_FN_CACHE.clear()
    barcodes = _barcodes(50, 9, seed=4)
    from fqtk_tpu.ops.matcher import ExpectedSet

    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)
    assign, pack_mode, host_matcher = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert host_matcher  # 50 <= 100


def test_cpu_backend_uses_static_cap(monkeypatch, tmp_path):
    """Without an accelerator backend the static 4096 cap applies and no
    probe artifacts appear (the test env pins JAX_PLATFORMS=cpu)."""
    monkeypatch.delenv("FQTK_HOST_MATCHER_MAX_K", raising=False)
    monkeypatch.setattr(
        demux_mod, "_CROSSOVER_CACHE_PATH", str(tmp_path / "crossover.json")
    )
    demux_mod._ASSIGN_FN_CACHE.clear()
    barcodes = _barcodes(30, 9, seed=5)
    from fqtk_tpu.ops.matcher import ExpectedSet

    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)
    assign, pack_mode, host_matcher = demux_mod._build_device_assign_fn(
        cfg, es, barcodes=barcodes
    )
    assert host_matcher and pack_mode == "nib4"
    assert not (tmp_path / "crossover.json").exists()


def test_cache_key_distinguishes_same_shape_whitelists(monkeypatch, tmp_path):
    """Two different whitelists with identical
    (K, L, batch, mm, delta) must NOT share a cached placement decision —
    host-matcher timing is content-dependent (IUPAC-heavy whitelists)."""
    _arm(monkeypatch, tmp_path, host_s=0.003, floor_s=0.025, device_s=None)
    from fqtk_tpu.ops.matcher import ExpectedSet

    barcodes_a = _barcodes(24, 9, seed=10)
    barcodes_b = _barcodes(24, 9, seed=11)
    assert barcodes_a != barcodes_b
    es_a = ExpectedSet.from_barcodes(barcodes_a)
    es_b = ExpectedSet.from_barcodes(barcodes_b)
    cfg_a = _cfg(tmp_path, barcodes_a)
    key_a = demux_mod._crossover_cache_key(cfg_a, es_a)
    key_b = demux_mod._crossover_cache_key(cfg_a, es_b)
    assert key_a != key_b, "same-shape whitelists must have independent keys"
    # same whitelist -> stable key (the disk cache still works at all)
    assert key_a == demux_mod._crossover_cache_key(
        cfg_a, ExpectedSet.from_barcodes(list(barcodes_a))
    )

    # end-to-end: decide for whitelist A, then whitelist B must re-probe
    demux_mod._build_device_assign_fn(cfg_a, es_a, barcodes=barcodes_a)
    probes = []
    monkeypatch.setattr(
        demux_mod,
        "_time_host_window",
        lambda m, w, reps=2: probes.append(1) or 0.003,
    )
    demux_mod._ASSIGN_FN_CACHE.clear()
    demux_mod._build_device_assign_fn(cfg_a, es_b, barcodes=barcodes_b)
    assert probes, "different whitelist content must trigger a fresh probe"


def test_window_dedup_wrapper_exact_and_bucketed(monkeypatch):
    """_wrap_window_dedup: clustered windows shrink to a power-of-two
    bucket of unique rows and scatter back exactly; low-duplication and
    small windows bypass."""
    monkeypatch.delenv("FQTK_DEVICE_DEDUP", raising=False)
    calls = []

    def fake_call(obs):
        obs = np.asarray(obs)
        calls.append(obs.shape[0])
        # fake matcher: "assignment" = first byte of the row
        return obs[:, 0].astype(np.int32)

    assign = demux_mod._wrap_window_dedup(fake_call)
    rng = np.random.default_rng(0)
    # 8192 rows drawn from 100 distinct 4-byte keys -> bucket 4096... no:
    # 100 unique -> bucket max(4096, 128) = 4096 < 8192, engages
    uniq = rng.integers(0, 255, size=(100, 4), dtype=np.uint8)
    rows = uniq[rng.integers(0, 100, size=8192)]
    out = assign(rows)
    np.testing.assert_array_equal(out, rows[:, 0].astype(np.int32))
    assert calls == [4096], calls
    assert assign.dedup_stats["dedup_windows"] == 1

    # low duplication: bypasses (unique > half)
    calls.clear()
    rows2 = rng.integers(0, 255, size=(4096, 8), dtype=np.uint8)
    out2 = assign(rows2)
    np.testing.assert_array_equal(out2, rows2[:, 0].astype(np.int32))
    assert calls == [4096]  # full window, no dedup call shrink

    # small windows: bypass entirely
    calls.clear()
    rows3 = uniq[rng.integers(0, 100, size=512)]
    out3 = assign(rows3)
    np.testing.assert_array_equal(out3, rows3[:, 0].astype(np.int32))
    assert calls == [512]

    # env kill switch
    monkeypatch.setenv("FQTK_DEVICE_DEDUP", "0")
    plain = demux_mod._wrap_window_dedup(fake_call)
    assert plain is fake_call


def test_cache_key_includes_device_kind(monkeypatch, tmp_path):
    """A placement measured on one card model must not steer another: the
    device kind is part of the cache key."""
    import jax

    from fqtk_tpu.ops.matcher import ExpectedSet

    barcodes = _barcodes(24, 9, seed=10)
    es = ExpectedSet.from_barcodes(barcodes)
    cfg = _cfg(tmp_path, barcodes)

    class _Dev:
        def __init__(self, kind):
            self.device_kind = kind

    keys = []
    for kind in ("NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-80GB"):
        monkeypatch.setattr(jax, "devices", lambda kind=kind: [_Dev(kind)])
        keys.append(demux_mod._crossover_cache_key(cfg, es))
    assert keys[0] != keys[1]
    assert "NVIDIA H100 80GB HBM3" in keys[0]


def test_device_probe_failure_warns_and_is_not_cached(monkeypatch, tmp_path, caplog):
    """A raising device probe runs the host matcher, logs a warning with the
    error, records it in the crossover info, and caches nothing."""
    import logging

    from fqtk_tpu.ops.matcher import ExpectedSet

    _arm(monkeypatch, tmp_path, host_s=0.003, floor_s=0.025, device_s=None)

    def boom(batch, width, reps=2):
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(demux_mod, "_device_floor_seconds", boom)
    barcodes = _barcodes(24, 9, seed=12)
    es = ExpectedSet.from_barcodes(barcodes)
    with caplog.at_level(logging.WARNING, logger="fqtk"):
        assign, pack_mode, host = demux_mod._build_device_assign_fn(
            _cfg(tmp_path, barcodes), es, barcodes=barcodes
        )
    assert host and assign.matcher == "host:brute-force"
    assert assign.crossover["crossover_device_failed"] == 1.0
    assert any("no CUDA device" in r.getMessage() for r in caplog.records)
    assert not (tmp_path / "crossover.json").exists()
