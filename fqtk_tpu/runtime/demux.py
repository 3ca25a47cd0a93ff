"""The demux pipeline: host streaming + device batch matching + routed output.

Device-batched re-design of the reference's ``Demux::execute``
(``/root/reference/src/bin/commands/demux.rs:881-1001``).  The reference is a
record-at-a-time loop (parse -> extract -> match via scalar hamming with a
memo cache -> write).  Here the pipeline is batch-oriented:

1. the native engine's persistent parse threads scan FASTQ records
   zero-copy into batch arenas and pack observed sample barcodes into a
   fixed-shape matrix (2-bit codes or 4-bit masks; too-short/too-long rows
   gated host-side, matching the reference),
2. one jitted device call computes the batch's assignments
   (:func:`fqtk_tpu.ops.matcher.make_assign_fn`, a mesh-sharded variant, or
   the host pigeonhole matcher for huge whitelists),
3. the engine's route thread rewrites headers and streams records to
   per-sample BGZF writers, accumulating per-sample counts natively.

Behavioral contract (error strings, skip-reason accounting, header rewriting,
output naming ``{sample_id}.{R|I|U|C}{n}.fq.gz``, ``demux-metrics.txt``)
follows the reference exactly; see the assertions cited inline.
"""

from __future__ import annotations

import logging
import os
import stat
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.encoding import count_nocalls, decode, encode
from ..core.headers import rewrite_header
from ..core.read_structure import (
    FILE_TYPE_CODE,
    ReadStructure,
    ReadStructureError,
    SegmentType,
)
from ..core.samples import SampleGroup
from ..io.fastq import BgzfWriter, FastqReader, open_reader
from ..ops.matcher import ExpectedSet, assign_batch_np
from ..utils.floatfmt import format_f64

logger = logging.getLogger("fqtk")

#: fixed iteration order of segment-type writers (reference ``demux.rs:397-402``)
_TYPE_ORDER = (
    SegmentType.Template,
    SegmentType.SampleBarcode,
    SegmentType.MolecularBarcode,
    SegmentType.CellularBarcode,
)


class DemuxError(RuntimeError):
    pass


#: default pipeline window: sized to amortize the device path's fixed
#: per-dispatch cost (transfer + launch) over many reads
DEFAULT_BATCH_SIZE = 1 << 17

#: window used when a HOST matcher is auto-selected and the user left
#: ``batch_size`` at the default: host assignment has no per-dispatch cost
#: to amortize, and small windows overlap parse/assign/route/compress far
#: better (measured faster on the single-end configs at 16K than at 128K)
HOST_MATCHER_BATCH = 1 << 14


@dataclass
class DemuxConfig:
    inputs: List[Path]
    read_structures: List[str]
    sample_metadata: Path
    output: Path
    output_types: List[str] = field(default_factory=lambda: ["T"])
    unmatched_prefix: str = "unmatched"
    max_mismatches: int = 1
    min_mismatch_delta: int = 2
    threads: int = 8
    compression_level: int = 5
    skip_reasons: List[str] = field(default_factory=list)
    # engine extensions (not in the reference CLI)
    batch_size: int = DEFAULT_BATCH_SIZE
    engine: str = "auto"  # auto | jax | numpy
    #: device count for the batch/whitelist mesh: None = all local devices
    #: (single-device path when only one is visible), 1 = force single
    devices: Optional[int] = None
    #: assignment placement: "auto" picks host matchers when the per-batch
    #: device round-trip would dominate (tiny K, single device) and the
    #: device paths otherwise; "host"/"device" force one side
    matcher: str = "auto"


@dataclass
class DemuxResult:
    metrics: List[dict]
    skip_counts: Dict[str, int]
    total_templates: int
    timings: Dict[str, float] = field(default_factory=dict)
    #: which matcher assigned the reads: ``host:<kind>`` or
    #: ``device:<kind>`` (native engine; empty for the Python engines)
    matcher: str = ""


class SampleWriters:
    """Per-sample writers, one per (requested output type, segment index)."""

    def __init__(
        self,
        name: str,
        output_dir: Path,
        read_structures: Sequence[ReadStructure],
        output_types: Sequence[SegmentType],
        compression_level: int,
    ):
        self.name = name
        self.writers: Dict[SegmentType, List[BgzfWriter]] = {}
        for seg_type in output_types:
            count = sum(len(rs.segments_by_type(seg_type)) for rs in read_structures)
            code = FILE_TYPE_CODE[seg_type]
            ws = [
                BgzfWriter(
                    output_dir / f"{name}.{code}{idx}.fq.gz", compression_level
                )
                for idx in range(1, count + 1)
            ]
            self.writers[seg_type] = ws

    def write(
        self,
        header: bytes,
        segs_by_type: Dict[SegmentType, List[Tuple[bytes, bytes]]],
        barcode_seqs: List[bytes],
        umi_seqs: List[bytes],
    ) -> None:
        for seg_type in _TYPE_ORDER:
            writers = self.writers.get(seg_type)
            if writers is None:
                continue
            segs = segs_by_type.get(seg_type, ())
            for read_idx, (writer, (seq, qual)) in enumerate(zip(writers, segs)):
                head = rewrite_header(header, read_idx + 1, barcode_seqs, umi_seqs)
                writer.write(head + b"\n" + seq + b"\n+\n" + qual + b"\n")

    def close(self) -> None:
        for ws in self.writers.values():
            for w in ws:
                w.close()


def _parse_output_types(chars: Sequence[str]) -> List[SegmentType]:
    types: List[SegmentType] = []
    for c in chars:
        types.append(SegmentType.from_char(c))
    # de-dup, stable order
    seen = set()
    out = []
    for t in types:
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def validate_and_prepare(cfg: DemuxConfig):
    """Input validation, mirroring ``demux.rs:806-875`` (messages included)."""
    errors: List[str] = []

    if len(cfg.inputs) != len(cfg.read_structures):
        errors.append(
            "The same number of read structures should be given as FASTQs "
            f"{len(cfg.read_structures)} read-structures provided for "
            f"{len(cfg.inputs)} FASTQs"
        )

    output = Path(cfg.output)
    if not output.exists():
        logger.info('Output directory "%s" didn\'t exist, creating it.', output)
        output.mkdir(parents=True, exist_ok=True)

    # the reference checks the permission BITS (fs::Permissions::readonly,
    # demux.rs:824-827), not effective access — matters for root, where
    # os.access() would say a chmod-555 directory is writable
    if output.stat().st_mode & 0o222 == 0:
        # NB: "Ouput" typo is the reference's operator-facing text (demux.rs:826)
        errors.append(f'Ouput directory "{output}" cannot be read-only')

    output_types: Optional[List[SegmentType]] = None
    try:
        output_types = _parse_output_types(cfg.output_types)
    except ReadStructureError as e:
        errors.append(f"Error parsing segment types to report: {e}")

    for inp in cfg.inputs:
        if not Path(inp).exists():
            errors.append(f'Provided input file "{inp}" doesn\'t exist')

    # attempt to open the files for reading (collected, first failure only —
    # the reference's Result collect short-circuits; demux.rs:843-851).
    # Stream inputs (pipes / process substitution / sockets) are exempt:
    # an open-close probe would block without a writer, or kill the writer
    # with SIGPIPE before the engine's single real open.
    for inp in cfg.inputs:
        try:
            mode = os.stat(inp).st_mode
            if stat.S_ISFIFO(mode) or stat.S_ISSOCK(mode) or stat.S_ISCHR(mode):
                continue
            with open(inp, "rb"):
                pass
        except OSError as e:
            errors.append(f"Error opening input files for reading: {e}")
            break

    if cfg.threads < 5:
        errors.append(
            f"Threads provided {cfg.threads} was too low! Must be 5 or more."
        )

    if not errors and output_types is not None and not output_types:
        errors.append(
            "No output types requested, must request at least one output segment type."
        )

    if errors:
        details = "Inputs failed validation!\n"
        for e in errors:
            details += f"    - {e}\n"
        raise DemuxError(
            f"The following errors with the input(s) were detected:\n{details}"
        )
    assert output_types is not None
    return output, output_types


def _too_few_bases_allowed(cfg: DemuxConfig) -> bool:
    allowed = set()
    for s in cfg.skip_reasons:
        if s in ("too few bases", "too-few-bases", "toofewbases"):
            allowed.add("TooFewBases")
        else:
            raise DemuxError(f"Invalid skip reason: {s}")
    return "TooFewBases" in allowed


#: whitelist size from which assignment goes to the host pigeonhole matcher
#: (exact-candidate filtering: work per read independent of K) and a
#: multi-device mesh shards the whitelist instead of the batch
BIG_K_THRESHOLD = 65536


def _host_matcher_max_k():
    """Optional explicit whitelist-size cap at or below which the auto
    policy keeps assignment on the host (brute-force ``SmallKMatcher``)
    instead of paying the per-batch device round-trip.

    Returns ``None`` when ``FQTK_HOST_MATCHER_MAX_K`` is unset — the auto
    policy then MEASURES the placement (one host-matcher window and, when
    the device round-trip floor doesn't already lose, one real device
    round-trip at the production batch; see :func:`_measured_placement`)
    instead of trusting a constant tuned for any one host.  Set the env var
    to pin the crossover (``FQTK_HOST_MATCHER_MAX_K=0`` routes every
    whitelist to the device paths; ``=4096`` is the static cap the CPU
    backend uses)."""
    v = os.environ.get("FQTK_HOST_MATCHER_MAX_K")
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        return 4096


#: disk cache of measured placement decisions, keyed per environment/shape
#: (a decision survives across processes; delete the file to re-measure, or
#: set FQTK_MEASURE_CROSSOVER=1 to force a fresh probe)
_CROSSOVER_CACHE_PATH = os.path.join(
    os.path.expanduser(os.environ.get("FQTK_CACHE_DIR", "~/.cache/fqtk")),
    "crossover.json",
)


def _time_host_window(matcher, win_nib4, reps=2) -> float:
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        matcher.assign(win_nib4)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _device_floor_seconds(batch: int, width: int, reps=2) -> float:
    """Lower bound for ANY per-window device call at this batch: transfer a
    [batch, width] uint8 array in and fetch a scalar reduction back (the
    fetch to the host ends the timed region)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(x):
        return jnp.sum(x.astype(jnp.int32))

    rng = np.random.default_rng(0xF100)
    ins = [
        rng.integers(0, 255, size=(batch, width), dtype=np.uint8)
        for _ in range(reps + 1)
    ]
    int(f(ins[-1]))  # compile + warm
    best = None
    for i in range(reps):
        t0 = time.perf_counter()
        int(f(ins[i]))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def _time_device_window(assign, windows) -> float:
    """Time the real device matcher on pre-packed windows (last = warmup)."""
    np.asarray(assign(windows[-1]))  # compile + warm
    best = None
    for w in windows[:-1]:
        t0 = time.perf_counter()
        np.asarray(assign(w))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


#: bump when the placement-relevant engine selection logic changes, so stale
#: cached decisions made under older auto-path thresholds are not reused
_CROSSOVER_KEY_VERSION = 3


def _crossover_cache_key(cfg: DemuxConfig, expected: ExpectedSet) -> str:
    import hashlib

    import jax

    # Host-matcher timing is content-dependent (IUPAC-heavy whitelists take a
    # different SIMD path; memo-cache hit rates differ), so two whitelists of
    # identical shape must never share a placement decision: key on a digest
    # of the encoded masks, not just (K, L).
    digest = hashlib.blake2b(
        np.ascontiguousarray(expected.masks).tobytes(), digest_size=16
    ).hexdigest()
    return "|".join(
        str(x)
        for x in (
            _CROSSOVER_KEY_VERSION,
            os.environ.get("JAX_PLATFORMS", ""),
            # a decision measured on one card model must not steer another
            jax.devices()[0].device_kind,
            expected.count,
            expected.length,
            digest,
            min(cfg.batch_size, 1 << 17),
            cfg.max_mismatches,
            cfg.min_mismatch_delta,
        )
    )


def _crossover_cache_get(key: str):
    if os.environ.get("FQTK_MEASURE_CROSSOVER") == "1":
        return None
    try:
        import json

        with open(_CROSSOVER_CACHE_PATH) as fh:
            return json.load(fh).get(key)
    except (OSError, ValueError):
        return None


def _crossover_cache_put(key: str, entry: dict) -> None:
    try:
        import json

        os.makedirs(os.path.dirname(_CROSSOVER_CACHE_PATH), exist_ok=True)
        data = {}
        try:
            with open(_CROSSOVER_CACHE_PATH) as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            pass
        data[key] = entry
        tmp = _CROSSOVER_CACHE_PATH + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, _CROSSOVER_CACHE_PATH)
    except OSError:
        pass


def _probe_allowed() -> bool:
    """Measured placement makes sense only when a real accelerator backend
    is present; on CPU-only JAX (tests, jax-less fallbacks) the static cap
    applies.  Separated for test monkeypatching."""
    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        return False
    try:
        import jax
    except ImportError:
        return False
    try:
        return jax.default_backend() != "cpu"
    except Exception:
        return False


def _host_assign_wrapper(matcher, kind="brute-force"):
    """Closure over the host matcher (keeps it alive, attribute-friendly).

    ``assign.native_matcher`` exposes the underlying native matcher so the
    native engine can FUSE it (engine-side assign thread, no per-window
    Python round trips; see ``NativeDemuxEngine.pipe_fuse_host_matcher``)."""

    def assign(obs_packed):
        return matcher.assign(obs_packed)

    assign.native_matcher = matcher
    assign.matcher = f"host:{kind}"
    return assign


def _measured_placement(cfg, expected, barcodes, host_builder):
    """Measure host-vs-device matcher placement at the production batch.

    Returns the chosen ``(assign, pack_mode, host_matcher)`` tuple, or
    ``None`` to let the caller fall through to the device paths.  The probe:

    1. time the host ``SmallKMatcher`` on a synthetic window (distinct
       random reads — the memo cache must not turn the probe into a cache
       benchmark);
    2. time the *device round-trip floor* (transfer + dispatch + fetch of a
       trivial program) — if the host already beats a bound no device call
       can beat, pick host without ever building/compiling the matcher;
    3. otherwise build the real device matcher, time it on the same window
       shape, and pick the faster side (10% hysteresis toward the host,
       which needs no device runtime).

    Decisions persist in a small disk cache so repeat runs skip the probe
    entirely — in particular, a cached "host" decision keeps JAX out of the
    process, preserving the round-3 cold-start property.

    On CPU-only JAX backends the probe is skipped and a static cap (4096)
    applies: an XLA-CPU "device" shares the silicon with the native SIMD
    matcher, so an A/B there would just pay a compile to compare two host
    paths.

    If the device probe raises, the host matcher runs this time; the error
    is logged as a warning, recorded in the crossover info
    (``crossover_device_failed``) and NOT cached, so the next run probes
    again."""
    if not _probe_allowed():
        if expected.count <= 4096:
            matcher = host_builder()
            if matcher is not None:
                logger.info(
                    "small-K brute-force host matcher selected (K=%d; CPU "
                    "backend, static crossover)",
                    expected.count,
                )
                return _host_assign_wrapper(matcher), "nib4", True
        return None
    key = _crossover_cache_key(cfg, expected)
    cached = _crossover_cache_get(key)
    if cached is not None and cached.get("choice") == "host":
        matcher = host_builder()
        if matcher is not None:
            logger.info(
                "matcher placement (cached): host (host %.3fms vs device "
                "%.3fms per %d-read window)",
                cached.get("host_s", 0) * 1e3,
                cached.get("device_s", cached.get("floor_s", 0)) * 1e3,
                cached.get("batch", 0),
            )
            fn = _host_assign_wrapper(matcher)
            _attach_crossover(fn, cached, "host")
            return fn, "nib4", True
        return None
    if cached is not None and cached.get("choice") == "device":
        out = _build_device_side(cfg, expected)
        logger.info(
            "matcher placement (cached): device (host %.3fms vs device "
            "%.3fms per %d-read window)",
            cached.get("host_s", 0) * 1e3,
            cached.get("device_s", 0) * 1e3,
            cached.get("batch", 0),
        )
        _attach_crossover(out[0], cached, "device")
        return out

    matcher = host_builder()
    if matcher is None:
        return None  # no host side to compare: device paths decide

    batch = min(cfg.batch_size, 1 << 17)
    length = expected.length
    rng = np.random.default_rng(0xF0CC)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    obs_list = [
        letters[rng.integers(0, 4, size=(batch, length))] for _ in range(3)
    ]
    from ..core.encoding import ENCODE_LUT

    def nib4(obs):
        m = ENCODE_LUT[obs]
        if length % 2:
            m = np.concatenate(
                [m, np.ones((batch, 1), dtype=np.uint8)], axis=1
            )
        return (m[:, 0::2] | (m[:, 1::2] << 4)).astype(np.uint8)

    host_s = _time_host_window(matcher, nib4(obs_list[0]))
    entry = {"host_s": host_s, "batch": batch}
    try:
        floor_s = _device_floor_seconds(batch, (length + 3) // 4)
    except Exception as exc:  # any device-runtime failure: report, run host
        logger.warning(
            "matcher placement: device probe failed (%s: %s); running the "
            "host matcher (host window %.3fms); decision not cached",
            type(exc).__name__,
            exc,
            host_s * 1e3,
        )
        entry.update(choice="host", device_failed=1.0)
        fn = _host_assign_wrapper(matcher)
        _attach_crossover(fn, entry, "host")
        return fn, "nib4", True
    entry["floor_s"] = floor_s
    if host_s <= floor_s:
        logger.info(
            "matcher placement measured: host %.3fms <= device floor %.3fms "
            "per %d-read window — host matcher selected (K=%d)",
            host_s * 1e3,
            floor_s * 1e3,
            batch,
            expected.count,
        )
        entry["choice"] = "host"
        _crossover_cache_put(key, entry)
        fn = _host_assign_wrapper(matcher)
        _attach_crossover(fn, entry, "host")
        return fn, "nib4", True

    # the device floor beats the host: measure the real matcher round-trip
    assign_dev, pack_mode, host_flag = _build_device_side(cfg, expected)
    code_lut = np.zeros(256, dtype=np.uint8)
    for c, ch in zip((0, 1, 2, 3), b"ACGT"):
        code_lut[ch] = c

    def bit2(obs):
        codes = code_lut[obs]
        w = -(-length // 4) * 4
        padded = np.zeros((batch, w), dtype=np.uint8)
        padded[:, :length] = codes
        return (
            padded[:, 0::4]
            | (padded[:, 1::4] << 2)
            | (padded[:, 2::4] << 4)
            | (padded[:, 3::4] << 6)
        ).astype(np.uint8)

    pack = bit2 if pack_mode == "bit2" else nib4
    device_s = _time_device_window(assign_dev, [pack(o) for o in obs_list])
    entry["device_s"] = device_s
    choice = "device" if device_s * 1.1 < host_s else "host"
    logger.info(
        "matcher placement measured: host %.3fms vs device %.3fms (floor "
        "%.3fms) per %d-read window — %s matcher selected (K=%d)",
        host_s * 1e3,
        device_s * 1e3,
        floor_s * 1e3,
        batch,
        choice,
        expected.count,
    )
    entry["choice"] = choice
    _crossover_cache_put(key, entry)
    if choice == "host":
        fn = _host_assign_wrapper(matcher)
        _attach_crossover(fn, entry, "host")
        return fn, "nib4", True
    _attach_crossover(assign_dev, entry, "device")
    return assign_dev, pack_mode, host_flag


def _attach_crossover(fn, entry: dict, choice: str) -> None:
    """Expose the placement decision for DemuxResult.timings (floats only)."""
    info = {"crossover_device_chosen": 1.0 if choice == "device" else 0.0}
    for k in ("host_s", "floor_s", "device_s", "device_failed"):
        if k in entry and np.isfinite(entry[k]):
            info[f"crossover_{k}"] = float(entry[k])
    try:
        fn.crossover = info
    except AttributeError:
        pass

#: process-level memo of device assign fns: repeated runs over the same
#: whitelist/params reuse the traced+compiled program (and, for the
#: pigeonhole path, the built candidate tables) instead of paying the
#: first-call tracing cost again
_ASSIGN_FN_CACHE: Dict[tuple, tuple] = {}


def _make_device_assign_fn(
    cfg: DemuxConfig, expected: ExpectedSet, barcodes=None
):
    if barcodes is None:
        # without the whitelist identity there is no safe cache key
        return _build_device_assign_fn(cfg, expected, barcodes)
    key = (
        tuple(barcodes),
        cfg.max_mismatches,
        cfg.min_mismatch_delta,
        cfg.devices,
        cfg.engine,
        cfg.matcher,
        cfg.threads,
        cfg.batch_size,  # mesh divisibility fallback depends on it
        BIG_K_THRESHOLD,  # policy inputs: keep tests/monkeypatching sound
        _host_matcher_max_k(),
    )
    cached = _ASSIGN_FN_CACHE.pop(key, None)
    if cached is not None:
        _ASSIGN_FN_CACHE[key] = cached  # LRU: refresh on hit
        return cached
    result = _build_device_assign_fn(cfg, expected, barcodes)
    if len(_ASSIGN_FN_CACHE) >= 4:  # bound device/table memory
        _ASSIGN_FN_CACHE.pop(next(iter(_ASSIGN_FN_CACHE)))
    _ASSIGN_FN_CACHE[key] = result
    return result


def _build_device_assign_fn(
    cfg: DemuxConfig, expected: ExpectedSet, barcodes=None
):
    """Packed-input device matcher for the native engine.  Returns
    ``(assign, pack_mode, host_matcher)`` where ``assign`` maps a packed
    observation matrix to ``assigned[B]``, ``host_matcher`` tells the
    caller assignment runs on the host (drives slicing semantics and the
    pipeline window size), and ``pack_mode`` tells the engine which
    packing to produce: ``"nib4"`` ([B, ceil(L/2)] 4-bit IUPAC nibbles) or
    ``"bit2"`` ([B, ceil(L/4)] 2-bit ACGT codes; ambiguous rows flagged
    exceptional and resolved host-side).

    Selection policy (``cfg.matcher`` forces one side; "auto" below):
    - huge whitelist + native lib: the host pigeonhole matcher
      (exact-candidate filtering beats brute force — even on the device —
      by orders of magnitude; see ``BigKMatcher`` in native/fqtk_io.cpp).
      Degenerate IUPAC whitelists are eligible too (expanded tables); only
      >16bp degenerate whitelists fall through to the device kernel.
    - tiny whitelist + native lib, unless ``--devices N>1``: the host
      brute-force matcher (``SmallKMatcher``) — the per-batch device
      round-trip exceeds the whole K*L host scan below
      ``FQTK_HOST_MATCHER_MAX_K``, and batch-sharding a tiny-K whitelist is
      transfer-bound, so this branch decides WITHOUT initializing JAX
      (keeps CLI cold start off the device runtime entirely).
    - multiple visible devices (or ``cfg.devices > 1``): shard over a mesh —
      huge whitelists shard K (cross-shard top-2 merge), everything else
      shards the batch axis (pure data parallelism, no collectives).
    - otherwise one device (see :func:`_build_device_side`).

    ``cfg.matcher == "device"`` never falls back to a host matcher.
    """
    from ..io import native as native_io

    big_k = expected.count >= BIG_K_THRESHOLD and expected.length <= 255
    policy = cfg.matcher or "auto"
    host_threads = max(2, min(cfg.threads - 1, os.cpu_count() or 4))

    if policy != "device" and big_k and barcodes is not None:
        try:
            matcher = native_io.NativeBigKMatcher(
                barcodes,
                cfg.max_mismatches,
                cfg.min_mismatch_delta,
                threads=host_threads,
            )
            logger.info(
                "big-K pigeonhole host matcher selected (K=%d, %d parts, "
                "%d threads)",
                expected.count,
                cfg.max_mismatches + max(cfg.min_mismatch_delta, 1),
                host_threads,
            )
            return _host_assign_wrapper(matcher, "pigeonhole"), "nib4", True
        except native_io.NativeLibraryError:
            raise
        except native_io.NativeDemuxError:
            pass  # ineligible whitelist: fall through

    def _host_small_k():
        """Build the host SmallKMatcher; None if the whitelist is
        ineligible."""
        try:
            return native_io.NativeSmallKMatcher(
                barcodes,
                cfg.max_mismatches,
                cfg.min_mismatch_delta,
                threads=host_threads,
            )
        except native_io.NativeLibraryError:
            raise
        except native_io.NativeDemuxError:
            return None  # ineligible whitelist: fall through to device paths

    cap = _host_matcher_max_k()
    if barcodes is not None and (
        policy == "host"
        or (
            policy == "auto"
            and cfg.devices in (None, 1)
            and cap is not None
            and expected.count <= cap
        )
    ):
        matcher = _host_small_k()
        if matcher is not None:
            logger.info(
                "small-K brute-force host matcher selected (K=%d, "
                "%d threads; device round-trip would dominate)",
                expected.count,
                host_threads,
            )
            return _host_assign_wrapper(matcher), "nib4", True
    elif (
        barcodes is not None
        and policy == "auto"
        and cfg.devices in (None, 1)
        and cap is None
    ):
        # No explicit cap: MEASURE the placement instead of guessing.  One
        # host-matcher timing and (when the device floor doesn't already
        # lose) one real device round-trip at the production batch decide;
        # the decision is disk-cached per environment/shape so repeat runs
        # skip the probe (and, for host decisions, skip JAX entirely).
        out = _measured_placement(cfg, expected, barcodes, _host_small_k)
        if out is not None:
            return out

    return _build_device_side(cfg, expected)


def _fused_kernel_ok(expected: ExpectedSet) -> bool:
    """The fused Triton matcher compiles for a GPU backend and is exact for
    barcodes up to 255 bp; anything else takes the XLA scan."""
    import jax

    return jax.default_backend() == "gpu" and expected.length <= 255


def _build_device_side(cfg: DemuxConfig, expected: ExpectedSet):
    """Device-path construction for the native engine: mesh sharding when
    multiple devices are requested/visible, the fused Triton kernel on a GPU
    backend, the XLA scan otherwise, and the NumPy spec on the host when
    jax is absent (never under ``--matcher device``).  Returns ``(assign,
    pack_mode, host_matcher)``.  Either device matcher takes bit2 windows
    (quarter-width transfers, a 4-class one-hot; ambiguous rows flagged by
    the engine and resolved host-side)."""
    big_k = expected.count >= BIG_K_THRESHOLD and expected.length <= 255
    try:
        import jax
    except ImportError:
        if cfg.matcher == "device":
            raise DemuxError("--matcher device requires jax") from None
        # jax is an optional extra: without it the native IO engine still
        # runs, assignment uses the NumPy executable spec
        from ..ops.matcher import assign_batch_np_masks

        logger.warning(
            "jax unavailable; assignment uses the NumPy spec on the host"
        )

        def assign_np_nib4(obs_packed):
            obs = np.asarray(obs_packed)
            b = obs.shape[0]
            masks = np.stack(
                [obs & 0xF, obs >> 4], axis=-1
            ).reshape(b, -1)[:, : expected.length]
            idx, _, _ = assign_batch_np_masks(
                masks, expected, cfg.max_mismatches, cfg.min_mismatch_delta
            )
            return np.where(idx < 0, expected.count, idx).astype(np.int32)

        assign_np_nib4.matcher = "host:numpy-spec"
        return assign_np_nib4, "nib4", True

    n_dev = cfg.devices if cfg.devices is not None else jax.local_device_count()
    n_dev = max(1, min(n_dev, jax.local_device_count()))
    # divisibility only constrains BATCH sharding; the big-K mesh shards the
    # whitelist axis (n_batch=1), so any batch size works there
    if n_dev > 1 and not big_k and cfg.batch_size % n_dev != 0:
        logger.warning(
            "batch size %d not divisible by %d devices; using a single device",
            cfg.batch_size,
            n_dev,
        )
        n_dev = 1

    if n_dev > 1:
        from ..parallel.mesh import make_demux_mesh, make_sharded_assign_fn

        if big_k:
            mesh = make_demux_mesh(n_batch=1, n_whitelist=n_dev)
        else:
            mesh = make_demux_mesh(n_batch=n_dev, n_whitelist=1)
        logger.info(
            "device mesh: %d-way %s parallelism over %d local devices",
            n_dev,
            "whitelist" if big_k else "batch",
            jax.local_device_count(),
        )
        fn = make_sharded_assign_fn(
            expected,
            cfg.max_mismatches,
            cfg.min_mismatch_delta,
            mesh,
            packed2=True,
            compact_output=True,
            with_counts=False,
            use_kernel=_fused_kernel_ok(expected),
        )
        assign = _wrap_window_dedup(fn)
        assign.matcher = "device:mesh-{}x{}:{}".format(
            *mesh.devices.shape,
            "triton-kernel" if fn.use_kernel else "xla-scan",
        )
        return assign, "bit2", False

    kernel = _fused_kernel_ok(expected)
    if kernel:
        from ..ops.pallas_matcher import make_pallas_assign_fn

        fn = make_pallas_assign_fn(
            expected,
            cfg.max_mismatches,
            cfg.min_mismatch_delta,
            packed2=True,
            compact_output=True,
        )
    else:
        from ..ops.matcher import make_assign_fn

        fn = make_assign_fn(
            expected,
            cfg.max_mismatches,
            cfg.min_mismatch_delta,
            packed2=True,
            compact_output=True,
        )
    logger.info(
        "device matcher: %s on %s",
        "fused Triton top-2 kernel" if kernel else "XLA scan",
        jax.devices()[0].device_kind,
    )

    def call(obs_packed):
        idx, _, _ = fn(obs_packed)
        return idx

    assign = _wrap_window_dedup(call)
    assign.matcher = "device:triton-kernel" if kernel else "device:xla-scan"
    return assign, "bit2", False


def _wrap_window_dedup(call):
    """Per-window dedup in front of a device matcher.

    The reference memoizes (read -> match) in a hash map
    (``barcode_matching.rs:173-182``); the host matchers rebuild that as
    direct-mapped per-worker tables.  This is the DEVICE path's analog:
    real single-cell windows carry thousands of reads per cell barcode, so
    ``np.unique`` over the packed observation keys shrinks the device batch
    by the duplication factor (measured 2.4x host-side on the clustered
    distribution; the device call cost scales ~linearly in rows).  Unique
    rows are padded to a power-of-two bucket so the jitted program count
    stays logarithmic, and results scatter back through the inverse map —
    bit-exact, because identical packed rows always score identically.

    Engages only when it pays: windows >= 4096 rows, packed width <= 8
    bytes (one u64 key — the universal <=32bp-bit2 / <=16bp-nib4 case),
    and at least 2x duplication.  ``FQTK_DEVICE_DEDUP=0`` disables."""
    if os.environ.get("FQTK_DEVICE_DEDUP", "1") == "0":
        return call

    stats = {"windows": 0, "dedup_windows": 0, "rows": 0, "unique": 0}

    def assign(obs_packed):
        obs = np.asarray(obs_packed)
        b, w = obs.shape
        stats["windows"] += 1
        if b >= 4096 and w <= 8:
            obs = np.ascontiguousarray(obs)
            if w in (1, 2, 4, 8):
                keys = obs.view(f"u{w}").reshape(b)
            else:
                full = np.zeros((b, 8), dtype=np.uint8)
                full[:, :w] = obs
                keys = full.view(np.uint64).reshape(b)
            uniq, first_idx, inv = np.unique(
                keys, return_index=True, return_inverse=True
            )
            nu = len(uniq)
            bucket = max(4096, 1 << max(0, (nu - 1).bit_length()))
            if nu <= b // 2 and bucket < b:
                rows = obs[first_idx]
                if bucket > nu:
                    rows = np.concatenate(
                        [rows, np.broadcast_to(rows[:1], (bucket - nu, w))]
                    )
                if stats["dedup_windows"] == 0:
                    logger.info(
                        "device window dedup engaged: %d unique of %d rows "
                        "(bucket %d)",
                        nu,
                        b,
                        bucket,
                    )
                stats["dedup_windows"] += 1
                stats["rows"] += b
                stats["unique"] += nu
                idx_u = np.asarray(call(np.ascontiguousarray(rows)))
                return idx_u[:nu][inv]
        return call(obs_packed)

    assign.dedup_stats = stats
    return assign


def _make_assigner(cfg: DemuxConfig, expected: ExpectedSet, engine_override=None):
    """Return a ``obs[B, L] uint8 -> assigned[B] int32`` callable.

    ``assigned == K`` denotes unmatched.
    """
    engine = engine_override or cfg.engine
    if engine in ("auto", "native"):
        try:
            import jax  # noqa: F401

            engine = "jax"
        except Exception:  # pragma: no cover
            engine = "numpy"
    if engine == "jax":
        from ..ops.matcher import make_assign_fn

        fn = make_assign_fn(expected, cfg.max_mismatches, cfg.min_mismatch_delta)

        def assign(obs: np.ndarray) -> np.ndarray:
            idx, _, _ = fn(obs)
            # writable copy: jax.Array views are read-only and callers
            # override rows (short/over-long barcodes -> unmatched)
            return np.array(idx)

        return assign

    def assign_np(obs: np.ndarray) -> np.ndarray:
        idx, _, _ = assign_batch_np(
            obs, expected, cfg.max_mismatches, cfg.min_mismatch_delta
        )
        return np.where(idx < 0, expected.count, idx).astype(np.int32)

    return assign_np


def _resolve_engine(engine: str) -> str:
    """auto -> native (C++ IO + device/host matcher).  The native library
    is built on first use; if that fails the run fails with the build
    error rather than switching to a Python engine."""
    return "native" if engine == "auto" else engine


def run_demux(cfg: DemuxConfig) -> DemuxResult:
    engine = _resolve_engine(cfg.engine)
    if engine == "native":
        return _run_demux_native(cfg)
    return _run_demux_python(cfg, engine)


def _run_demux_native(cfg: DemuxConfig) -> DemuxResult:
    """Hot path: C++ engine does parse/extract/route/compress; the device
    does assignment; Python only moves batch handles."""
    from ..io import native as native_io

    try:
        native_io.get_lib()
    except native_io.NativeLibraryError as e:
        raise DemuxError(str(e)) from None
    output, output_types = validate_and_prepare(cfg)
    skip_too_few = _too_few_bases_allowed(cfg)

    sample_group = SampleGroup.from_file(cfg.sample_metadata)
    logger.info(
        "%d samples loaded from file %s", len(sample_group.samples), cfg.sample_metadata
    )

    structures = [ReadStructure.from_str(s) for s in cfg.read_structures]
    expected = ExpectedSet.from_barcodes([s.barcode for s in sample_group.samples])
    bc_len = expected.length
    k = expected.count
    # packed transfers (2-bit codes or 4-bit masks) + compact uint8 results:
    # quarters/halves the host<->device traffic on the hot path
    assign, pack_mode, host_matcher = _make_device_assign_fn(
        cfg, expected, barcodes=[s.barcode for s in sample_group.samples]
    )

    packed_len = (bc_len + 3) // 4 if pack_mode == "bit2" else (bc_len + 1) // 2

    engine = native_io.NativeDemuxEngine(
        threads=max(1, cfg.threads - 2), compression_level=cfg.compression_level
    )
    try:
        for path, rs in zip(cfg.inputs, structures):
            engine.add_input(
                str(path),
                str(rs),
                [(s.offset, s.length, s.kind.value) for s in rs],
            )

        requested = [t for t in _TYPE_ORDER if t in output_types]
        names = [s.sample_id for s in sample_group.samples] + [cfg.unmatched_prefix]
        files_per_sample = sum(
            sum(len(rs.segments_by_type(t)) for rs in structures) for t in requested
        )
        try:
            import resource

            fd_limit = resource.getrlimit(resource.RLIMIT_NOFILE)[1]
            resource.setrlimit(resource.RLIMIT_NOFILE, (fd_limit, fd_limit))
            if fd_limit == resource.RLIM_INFINITY:  # -1: unlimited, not tiny
                fd_limit = 1 << 30
        except Exception:  # pragma: no cover
            fd_limit = 1 << 20
        if len(names) * files_per_sample + 64 > fd_limit:
            raise DemuxError(
                f"{len(names)} samples x {files_per_sample} output files exceeds "
                f"this system's open-file limit ({fd_limit}); reduce samples or "
                f"output types, or raise the limit"
            )
        for name in names:
            paths = []
            for seg_type in requested:
                count = sum(
                    len(rs.segments_by_type(seg_type)) for rs in structures
                )
                code = FILE_TYPE_CODE[seg_type]
                paths += [
                    str(output / f"{name}.{code}{idx}.fq.gz")
                    for idx in range(1, count + 1)
                ]
            engine.add_sample(paths)
        logger.info("Created sample and %s writers.", cfg.unmatched_prefix)

        engine.configure(
            bc_len=bc_len,
            nocall_budget=cfg.max_mismatches + expected.max_ns_in_barcodes,
            skip_too_few=skip_too_few,
            first_sample_id=sample_group.samples[0].sample_id,
            first_barcode=sample_group.samples[0].barcode.upper(),
            out_types="".join(t.value for t in requested),
            pack_mode=2 if pack_mode == "bit2" else 1,
        )

        skip_counts: Dict[str, int] = {}
        total = 0
        skipped_total = 0
        next_log = 1_000_000
        batch = cfg.batch_size
        if host_matcher and batch == DEFAULT_BATCH_SIZE:
            batch = HOST_MATCHER_BATCH

        from ..utils.profiling import StageTimers, maybe_device_trace

        timers = StageTimers()

        # The batch loop lives entirely in C++ (persistent per-input parse
        # threads filling a 4-slot window ring + a dedicated route thread
        # feeding the BGZF compressor pool); this thread only services
        # device-matcher calls between acquire and submit.  All native calls
        # release the GIL.
        # Fractional ramp-up windows are OFF by default: an interleaved A/B
        # measured them a consistent loss on the single-end config and a
        # wash on dual-index — the 3 extra window handoffs cost more than
        # the earlier route/compress start saves.  FQTK_PIPE_RAMP=1 re-enables
        # (host-matcher runs only; device matchers compile per shape).
        ramp = os.environ.get("FQTK_PIPE_RAMP") == "1" and host_matcher
        # Fused host-matcher mode (default when placement picked a host
        # matcher): the engine's own assign thread scores each gated window
        # between gate_pack and route, so this thread never round-trips
        # through ctypes per window — it only polls progress counters.
        # FQTK_FUSED_ASSIGN=0 restores the per-window Python round trip.
        fused = (
            host_matcher
            and os.environ.get("FQTK_FUSED_ASSIGN", "1") != "0"
            and getattr(assign, "native_matcher", None) is not None
            and engine.pipe_fuse_host_matcher(assign.native_matcher)
        )
        engine.pipe_start(batch, packed_len, ramp=ramp)
        first = True
        with maybe_device_trace():
            while fused:
                state, total, skipped_total = engine.pipe_fused_poll(50)
                while total >= next_log:
                    logger.info(
                        "fqtk: %s records demultiplexed", f"{next_log:,}"
                    )
                    next_log += 1_000_000
                if state != 0:
                    # drained (1) or error (-1; pipe_finish raises with the
                    # engine's message)
                    break
            # Device-placement runs keep ONE window's device call in flight:
            # window N+1's transfer+execute is dispatched before window N's
            # result is fetched, hiding the fixed per-call transfer cost
            # behind the fetch/route of the previous window.  Safe because a
            # slot's bc buffer stays valid until ITS pipe_submit, and the
            # pending window is always fetched before being submitted.
            overlap = not host_matcher and os.environ.get(
                "FQTK_DEVICE_OVERLAP", "1"
            ) != "0"
            pending = None  # (slot, n, in-flight device result)
            compile_logged = False

            def resolve_and_submit(p_slot, p_n, assigned):
                # shared tail for the overlap and serial arms (they must
                # stay byte-identical; pinned by
                # test_device_overlap_byte_identical)
                nonlocal total, next_log
                if pack_mode == "bit2":
                    # rows with ambiguous/no-call bytes could not be 2-bit
                    # encoded: resolve them with the NumPy spec (exact,
                    # incl. IUPAC masks; the no-call gate already ran in
                    # C++)
                    exc_idx, exc_raw = engine.pipe_exceptional(p_slot)
                    if exc_idx is not None:
                        with timers.time("exceptional"):
                            eidx, _, _ = assign_batch_np(
                                exc_raw,
                                expected,
                                cfg.max_mismatches,
                                cfg.min_mismatch_delta,
                            )
                            assigned[exc_idx] = np.where(
                                eidx < 0, k, eidx
                            ).astype(np.int32)
                with timers.time("submit"):
                    engine.pipe_submit(p_slot, assigned)
                total += p_n
                while total >= next_log:
                    logger.info(
                        "fqtk: %s records demultiplexed", f"{next_log:,}"
                    )
                    next_log += 1_000_000

            def finish_pending():
                nonlocal pending, first
                p_slot, p_n, fut = pending
                pending = None
                with timers.time("assign"):
                    assigned = np.asarray(fut)[:p_n].astype(np.int32)
                if first:
                    first = False
                    logger.info("device matcher ready.")
                resolve_and_submit(p_slot, p_n, assigned)

            while not fused:
                with timers.time("acquire_wait"):
                    n, slot, bc_view, sk = engine.pipe_acquire()
                skipped_total += sk
                if n == 0:
                    if pending is not None:
                        finish_pending()
                    break
                if not host_matcher and not compile_logged:
                    compile_logged = True
                    logger.info(
                        "compiling device matcher (first run of a new "
                        "samples/length/batch configuration can take minutes; "
                        "subsequent runs hit the persistent cache)..."
                    )
                if overlap:
                    with timers.time("dispatch"):
                        fut = assign(bc_view)
                    if pending is not None:
                        finish_pending()
                    pending = (slot, n, fut)
                    continue
                with timers.time("assign"):
                    if host_matcher:
                        # host matchers have no fixed-shape compilation
                        # constraint: scan only the n valid rows (a leading-
                        # axis slice of the C-order view is still contiguous)
                        assigned = np.asarray(assign(bc_view[:n])).astype(
                            np.int32
                        )
                    else:
                        # dispatch + fetch; the zero-copy bc view is consumed
                        # by the device transfer before asarray returns
                        assigned = np.asarray(assign(bc_view))[:n].astype(
                            np.int32
                        )
                if first:
                    first = False
                    if not host_matcher:
                        logger.info("device matcher ready.")
                resolve_and_submit(slot, n, assigned)

        logger.info("Finished reading input FASTQs.")
        with timers.time("finish"):
            engine.pipe_finish()
        logger.info("Output FASTQ writing complete.")
        counts = engine.counts(k + 1)
        if skipped_total:
            skip_counts["TooFewBases"] = skipped_total
        timers.log(total)
        native_stats = engine.stats()
        logger.info(
            "native stage times (thread-summed): %s",
            {k_: round(v, 3) for k_, v in native_stats.items()},
        )
    except native_io.NativeDemuxError as e:
        raise DemuxError(str(e)) from None
    finally:
        engine.close()

    if not skip_counts:
        logger.info("No records were skipped.")
    else:
        for reason, count in sorted(skip_counts.items(), key=lambda kv: kv[1]):
            logger.info("%d records were skipped due to Too few bases", count)

    metrics = compute_metrics(sample_group, counts, cfg.unmatched_prefix)
    write_metrics(output / "demux-metrics.txt", metrics)
    return DemuxResult(
        metrics=metrics,
        skip_counts=skip_counts,
        total_templates=int(counts.sum()),
        matcher=getattr(assign, "matcher", ""),
        timings={
            **timers.summary(),
            **native_stats,
            # measured matcher-placement decision, when the auto policy
            # probed one (see _measured_placement)
            **getattr(assign, "crossover", {}),
        },
    )


def _run_demux_python(cfg: DemuxConfig, engine: str) -> DemuxResult:
    output, output_types = validate_and_prepare(cfg)
    skip_too_few = _too_few_bases_allowed(cfg)

    sample_group = SampleGroup.from_file(cfg.sample_metadata)
    logger.info(
        "%d samples loaded from file %s", len(sample_group.samples), cfg.sample_metadata
    )

    structures = [ReadStructure.from_str(s) for s in cfg.read_structures]
    min_lens = [rs.min_length() for rs in structures]

    expected = ExpectedSet.from_barcodes([s.barcode for s in sample_group.samples])
    bc_len = expected.length
    k = expected.count
    nocall_budget = cfg.max_mismatches + expected.max_ns_in_barcodes
    assign = _make_assigner(cfg, expected, engine_override=engine)

    readers = [
        FastqReader(open_reader(p), str(p)) for p in cfg.inputs
    ]

    writer_sets = [
        SampleWriters(s.sample_id, output, structures, output_types, cfg.compression_level)
        for s in sample_group.samples
    ]
    writer_sets.append(
        SampleWriters(
            cfg.unmatched_prefix, output, structures, output_types, cfg.compression_level
        )
    )
    logger.info("Created sample and %s writers.", cfg.unmatched_prefix)

    counts = np.zeros(k + 1, dtype=np.int64)
    skip_counts: Dict[str, int] = {}
    total = 0
    batch_size = cfg.batch_size

    # batch buffers
    headers: List[bytes] = []
    seg_lists: List[list] = []  # per template: [(kind, seq, qual), ...]
    barcodes: List[bytes] = []

    def flush_batch() -> None:
        nonlocal total
        b = len(headers)
        if b == 0:
            return
        obs = np.full((batch_size, bc_len), ord("A"), dtype=np.uint8)
        override = {}  # row -> forced index (K = unmatched)
        for row, bc in enumerate(barcodes):
            if len(bc) == bc_len:
                obs[row] = np.frombuffer(bc, dtype=np.uint8)
            elif len(bc) < bc_len:
                override[row] = k  # reference: assign() -> None (demux len gate)
            else:
                # reference order: no-call gate fires before the length panic
                # (barcode_matching.rs:165-186)
                if count_nocalls(bc) > nocall_budget:
                    override[row] = k
                else:
                    s0 = sample_group.samples[0]
                    obs_str = decode(encode(bc))
                    raise DemuxError(
                        f"Read barcode ({obs_str}) length ({len(bc)}) differs from "
                        f"expected barcode ({s0.barcode.upper()}) length ({bc_len}) "
                        f"for sample {s0.sample_id}"
                    )
        assigned = assign(obs)[:b]
        for row, forced in override.items():
            if row < b:
                assigned[row] = forced
        counts[: k + 1] += np.bincount(assigned, minlength=k + 1)

        for row in range(b):
            idx = int(assigned[row])
            segs = seg_lists[row]
            segs_by_type: Dict[SegmentType, List[Tuple[bytes, bytes]]] = {}
            bc_seqs: List[bytes] = []
            umi_seqs: List[bytes] = []
            for kind, seq, qual in segs:
                segs_by_type.setdefault(kind, []).append((seq, qual))
                if kind == SegmentType.SampleBarcode:
                    bc_seqs.append(seq)
                elif kind == SegmentType.MolecularBarcode:
                    umi_seqs.append(seq)
            writer_sets[idx].write(headers[row], segs_by_type, bc_seqs, umi_seqs)
            total += 1
            if total % 1_000_000 == 0:
                logger.info("fqtk: %s records demultiplexed", f"{total:,}")
        headers.clear()
        seg_lists.clear()
        barcodes.clear()

    while True:
        # positional read: EOF'd inputs keep a None placeholder so each record
        # pairs with its OWN read structure (the reference's gate runs inside
        # each per-file ReadSetIterator, demux.rs:298-314)
        all_recs = [next(r, None) for r in readers]
        recs = [rec for rec in all_recs if rec is not None]

        # per-input min-length gate against that input's structure
        skip_template = False
        for rec, rs, min_len in zip(all_recs, structures, min_lens):
            if rec is None:
                continue
            if len(rec.seq) < min_len:
                if skip_too_few:
                    skip_template = True
                else:
                    raise DemuxError(
                        f"Read {rec.head.decode('utf-8', 'replace')} had too few bases "
                        f"to demux {len(rec.seq)} vs. {min_len} needed in read "
                        f"structure {rs}."
                    )
        # reference order: skip-reason check precedes both the EOF break and
        # the sync assert (demux.rs:954-966)
        if skip_template:
            skip_counts["TooFewBases"] = skip_counts.get("TooFewBases", 0) + 1
            continue
        if not recs:
            break
        if len(recs) != len(readers):
            raise DemuxError(
                f"FASTQ sources out of sync at records: {[r.head for r in recs]}"
            )

        segs: list = []
        bc_parts: List[bytes] = []
        for rec, rs in zip(recs, structures):
            for seg_index, seg in enumerate(rs):
                try:
                    seq, qual = seg.extract_bases_and_quals(rec.seq, rec.qual)
                except ReadStructureError as e:
                    raise DemuxError(
                        f"Error extracting bases (len: {len(rec.seq)}) or quals "
                        f"(len: {len(rec.qual)}) for the {seg_index}th read segment "
                        f"({seg}) in read structure ({rs}) from FASTQ record with "
                        f"name {rec.head.decode('utf-8', 'replace')}; {e}"
                    ) from None
                segs.append((seg.kind, seq, qual))
                if seg.kind == SegmentType.SampleBarcode:
                    bc_parts.append(seq)

        headers.append(recs[0].head)
        seg_lists.append(segs)
        barcodes.append(b"".join(bc_parts))
        if len(headers) >= batch_size:
            flush_batch()

    flush_batch()

    logger.info("Finished reading input FASTQs.")
    for ws in writer_sets:
        ws.close()
    for r in readers:
        r.close()
    logger.info("Output FASTQ writing complete.")

    if not skip_counts:
        logger.info("No records were skipped.")
    else:
        for reason, count in sorted(skip_counts.items(), key=lambda kv: kv[1]):
            logger.info("%d records were skipped due to Too few bases", count)

    metrics = compute_metrics(sample_group, counts, cfg.unmatched_prefix)
    write_metrics(output / "demux-metrics.txt", metrics)
    return DemuxResult(
        metrics=metrics, skip_counts=skip_counts, total_templates=int(counts.sum())
    )


def compute_metrics(
    sample_group: SampleGroup, counts: np.ndarray, unmatched_prefix: str
) -> List[dict]:
    """Derived metrics per sample (reference ``demux.rs:481-496``)."""
    n = len(sample_group.samples)
    templates = counts[:n].astype(np.float64)
    unmatched = np.float64(counts[n])
    with np.errstate(divide="ignore", invalid="ignore"):
        sample_total = templates.sum()
        total = sample_total + unmatched
        mean = sample_total / np.float64(n)
        best = np.float64(templates.max() if n else 0.0)
        rows = []
        for i, s in enumerate(sample_group.samples):
            t = templates[i]
            rows.append(
                dict(
                    sample_id=s.sample_id,
                    barcode=s.barcode,
                    templates=int(t),
                    frac_templates=float(t / total),
                    ratio_to_mean=float(t / mean),
                    ratio_to_best=float(t / best),
                )
            )
        rows.append(
            dict(
                sample_id=unmatched_prefix,
                barcode=".",
                templates=int(unmatched),
                frac_templates=float(unmatched / total),
                ratio_to_mean=float(unmatched / mean),
                ratio_to_best=float(unmatched / best),
            )
        )
    return rows


def write_metrics(path: Path, metrics: List[dict]) -> None:
    cols = [
        "sample_id",
        "barcode",
        "templates",
        "frac_templates",
        "ratio_to_mean",
        "ratio_to_best",
    ]
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\t".join(cols) + "\n")
        for row in metrics:
            fields = [
                str(row["sample_id"]),
                str(row["barcode"]),
                str(row["templates"]),
                format_f64(row["frac_templates"]),
                format_f64(row["ratio_to_mean"]),
                format_f64(row["ratio_to_best"]),
            ]
            fh.write("\t".join(fields) + "\n")
