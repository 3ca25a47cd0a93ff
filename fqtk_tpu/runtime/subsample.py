"""Synchronized Bernoulli subsampling of parallel FASTQ files.

Equivalent of the reference's ``subsample`` command
(``/root/reference/src/bin/commands/subsample.rs``): one ChaCha8 ``f64`` draw
per record set (drawn BEFORE reading, ``subsample.rs:232``), lockstep
iteration over all inputs, read-name sync checking against file 0, and
verbatim pass-through of kept records to BGZF outputs named
``{output}.R{i}.fq.gz``.

Seed semantics: with ``--seed``, the keep/drop mask is bit-identical to the
reference (same ChaCha8 stream, see :mod:`fqtk_tpu.utils.chacha`).  Without a
seed the reference derives one by Rust's ``DefaultHasher`` (SipHash-1-3, zero
key) over its CLI struct (``subsample.rs:92-129``); we reproduce that
derivation — SipHash core, Rust ``Hash`` field encodings, and ``Path``
hashing — in :mod:`fqtk_tpu.utils.siphash`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

from ..io.fastq import BgzfWriter, chomp_line, open_reader

logger = logging.getLogger("fqtk")

#: reference progress cadence: one log line per 5M record sets
#: (subsample.rs:224,277-285)
PROGRESS_LOG_UNIT = 5_000_000


class SubsampleError(RuntimeError):
    pass


def fmt_count(n: int) -> str:
    """Comma-grouped count formatting (reference ``subsample.rs:21-31``)."""
    return f"{n:,}"


def base_read_name(head: bytes) -> bytes:
    """Name portion of a FASTQ header: strip comment (space/tab) and a
    trailing ``/1`` or ``/2`` (reference ``subsample.rs:106-117``)."""
    name_end = len(head)
    for i, b in enumerate(head):
        if b in (0x20, 0x09):
            name_end = i
            break
    name = head[:name_end]
    if len(name) >= 2 and name[-2:-1] == b"/" and name[-1:] in (b"1", b"2"):
        return name[:-2]
    return name


@dataclass
class SubsampleConfig:
    inputs: List[Path]
    output: Path
    fraction: float
    threads: int = 8
    compression_level: int = 5
    seed: Optional[int] = None
    disable_read_name_checking: bool = False


@dataclass
class SubsampleResult:
    total_read: int
    total_kept: int
    seed: int
    # native engines only: per-stage thread-CPU seconds + pool byte counts,
    # consumed by bench.py's host-ceiling accounting (None on the Python path)
    stage_seconds: Optional[dict] = None


def effective_seed(cfg: SubsampleConfig) -> int:
    """Explicit seed, or the reference's deterministic DefaultHasher
    derivation over the parameter struct (``subsample.rs:122-129``)."""
    if cfg.seed is not None:
        return cfg.seed
    from ..utils.siphash import subsample_effective_seed

    return subsample_effective_seed(
        inputs=[str(p) for p in cfg.inputs],
        output=str(cfg.output),
        fraction=cfg.fraction,
        threads=cfg.threads,
        compression_level=cfg.compression_level,
        seed=None,
        disable_read_name_checking=cfg.disable_read_name_checking,
    )


def validate(cfg: SubsampleConfig) -> None:
    """Collected validation errors (reference ``subsample.rs:132-172``)."""
    errors: List[str] = []
    if not cfg.inputs:
        errors.append("At least one input file is required.")
    for inp in cfg.inputs:
        if not Path(inp).exists():
            errors.append(f'Input file "{inp}" does not exist.')
    if not (0.0 <= cfg.fraction <= 1.0):
        errors.append(f"Fraction must be in [0.0, 1.0], got {cfg.fraction}.")
    if cfg.threads < 2:
        errors.append(f"Threads must be at least 2, got {cfg.threads}.")
    if not (1 <= cfg.compression_level <= 12):
        errors.append(
            f"Compression level must be 1-12, got {cfg.compression_level}."
        )
    parent = Path(cfg.output).parent
    if str(parent) and not parent.exists():
        errors.append(f'Output parent directory "{parent}" does not exist.')
    if errors:
        details = "".join(f"    - {e}\n" for e in errors)
        raise SubsampleError(
            f"The following errors with the input(s) were detected:\n{details}"
        )


def _run_subsample_native(cfg: SubsampleConfig, rng, seed: int) -> SubsampleResult:
    """Hot path: C++ reads/writes; Python supplies the ChaCha8 keep mask in
    chunks (one draw per record set, in stream order — identical to the
    reference's draw-before-read loop).

    Mask generation (~3.4ms per 64K chunk of pure-Python ChaCha8) runs one
    chunk AHEAD on a producer thread: ``process_chunk`` releases the GIL
    for the whole C++ call, so drawing mask N+1 overlaps chunk N instead
    of stalling the readers between chunks (measured ~20% of subsample
    wall before the overlap).  The stream order is unchanged — masks are
    drawn and applied in sequence; at EOF the one extra drawn chunk is
    discarded, which matches the reference's draw-before-read loop
    (``subsample.rs:231-238``) drawing for a record set that turns out
    not to exist."""
    import queue
    import threading

    from ..io import native as native_io

    engine = native_io.NativeSubsampleEngine(
        threads=max(1, cfg.threads - 1), compression_level=cfg.compression_level
    )
    try:
        for i, inp in enumerate(cfg.inputs):
            engine.add_input(inp, f"{cfg.output}.R{i + 1}.fq.gz")
        engine.configure(check_names=not cfg.disable_read_name_checking)
        logger.info(
            "Subsampling %d input file(s) at fraction %.4f to %s",
            len(cfg.inputs),
            cfg.fraction,
            cfg.output,
        )
        chunk = 1 << 18
        log_unit = PROGRESS_LOG_UNIT
        total_read = 0
        total_kept = 0

        masks: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        producer_err = []

        # the native ChaCha8 mask stream (bit-identical to the NumPy rng,
        # pinned by tests/test_subsample.py) costs ~13ns/draw vs ~50, so the
        # producer thread stops competing with the compressor pool for cores
        try:
            native_rng = native_io.NativeChaChaMask(seed)
        except native_io.NativeDemuxError:  # stale .so without the export
            native_rng = None

        def draw_mask(take: int):
            if native_rng is not None:
                return native_rng.keep_mask(take, cfg.fraction)
            return (rng.random_f64_batch(take) < cfg.fraction).astype("uint8")

        def produce():
            # take sizes never straddle a progress boundary so the 5M lines
            # carry the exact counts the reference would log; the schedule
            # is deterministic in drawn-records, so the producer can run
            # ahead of consumption
            drawn = 0
            try:
                while not stop.is_set():
                    until_log = log_unit - (drawn % log_unit)
                    take = min(chunk, until_log)
                    mask = draw_mask(take)
                    drawn += take
                    while not stop.is_set():
                        try:
                            masks.put((take, mask), timeout=0.2)
                            break
                        except queue.Full:
                            continue
            except Exception as e:  # pragma: no cover - numpy OOM etc.
                producer_err.append(e)
                masks.put((0, None))

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                take, mask = masks.get()
                if producer_err:
                    raise producer_err[0]
                consumed, kept = engine.process_chunk(mask)
                total_read += consumed
                total_kept += kept
                if total_read and total_read % log_unit == 0 and consumed == take:
                    logger.info(
                        "[fqtk subsample] Read %s record sets and wrote %s (%.1f%%).",
                        fmt_count(total_read),
                        fmt_count(total_kept),
                        total_kept / total_read * 100.0,
                    )
                if consumed < take:
                    break
        finally:
            stop.set()
            while True:  # unblock a producer waiting on a full queue
                try:
                    masks.get_nowait()
                except queue.Empty:
                    break
            producer.join()
        logger.info("Finished reading input FASTQs.")
        engine.finish()
        stage_seconds = engine.stats()
    except native_io.NativeDemuxError as e:
        raise SubsampleError(str(e)) from None
    finally:
        engine.close()

    pct = total_kept / total_read * 100.0 if total_read > 0 else 0.0
    logger.info(
        "[fqtk subsample] Read %s record sets and wrote %s (%.1f%%).",
        fmt_count(total_read),
        fmt_count(total_kept),
        pct,
    )
    return SubsampleResult(
        total_read=total_read,
        total_kept=total_kept,
        seed=seed,
        stage_seconds=stage_seconds,
    )


class _RawFastqReader:
    """4-line record reader that keeps the separator line verbatim so kept
    records pass through byte-identically (``rec.write_unchanged``,
    reference ``subsample.rs:256``).  Line endings are normalized to LF."""

    def __init__(self, stream, name: str):
        self._stream = stream
        self._name = name

    # one newline + at most ONE CR, matching the native scanner — single
    # source of truth in io/fastq.py so the demux and subsample Python
    # paths can never desynchronize
    _chomp = staticmethod(chomp_line)

    def next_record(self):
        head = self._stream.readline()
        if not head:
            return None
        seq = self._stream.readline()
        plus = self._stream.readline()
        qual = self._stream.readline()
        if not qual:
            raise SubsampleError(f"{self._name}: truncated FASTQ record {head!r}")
        if head[:1] != b"@" or plus[:1] != b"+":
            raise SubsampleError(f"{self._name}: malformed FASTQ record {head!r}")
        return (
            self._chomp(head),
            self._chomp(seq),
            self._chomp(plus),
            self._chomp(qual),
        )

    def close(self):
        self._stream.close()


def run_subsample(cfg: SubsampleConfig, use_native: Optional[bool] = None) -> SubsampleResult:
    validate(cfg)

    seed = effective_seed(cfg)
    logger.info("Using random seed: %d", seed)
    from ..utils.chacha import ChaCha8Rng

    rng = ChaCha8Rng(seed)

    if use_native is not False:
        from ..io import native as native_io

        try:
            native_io.get_lib()
        except native_io.NativeLibraryError as e:
            raise SubsampleError(str(e)) from None
        return _run_subsample_native(cfg, rng, seed)

    sources = [_RawFastqReader(open_reader(p), str(p)) for p in cfg.inputs]
    writers = [
        BgzfWriter(f"{cfg.output}.R{i + 1}.fq.gz", cfg.compression_level)
        for i in range(len(cfg.inputs))
    ]

    logger.info(
        "Subsampling %d input file(s) at fraction %.4f to %s",
        len(cfg.inputs),
        cfg.fraction,
        cfg.output,
    )

    log_unit = PROGRESS_LOG_UNIT
    num_inputs = len(sources)
    check_names = not cfg.disable_read_name_checking and num_inputs > 1
    expected_name = b""
    total_read = 0
    total_kept = 0

    # Draw batches of f64s up front (one per record set, in stream order) —
    # equivalent to the reference's per-iteration draw since draws happen
    # before reads and exactly once per loop iteration.
    draw_buf = rng.random_f64_batch(65536)
    draw_pos = 0

    while True:
        if draw_pos >= len(draw_buf):
            draw_buf = rng.random_f64_batch(65536)
            draw_pos = 0
        keep = draw_buf[draw_pos] < cfg.fraction
        draw_pos += 1

        records_found = 0
        for i, source in enumerate(sources):
            rec = source.next_record()
            if rec is None:
                continue
            records_found += 1
            if keep:
                head, seq, plus, qual = rec
                if check_names:
                    name = base_read_name(head[1:])
                    if i == 0:
                        expected_name = name
                    elif name != expected_name:
                        raise SubsampleError(
                            f"Read name mismatch at read {total_read + 1}: "
                            f'file 0="{expected_name.decode("utf-8", "replace")}", '
                            f'file {i}="{name.decode("utf-8", "replace")}"'
                        )
                writers[i].write(head + b"\n" + seq + b"\n" + plus + b"\n" + qual + b"\n")

        if records_found == 0:
            break
        if records_found != num_inputs:
            raise SubsampleError(
                f"FASTQ files are out of sync: {records_found} of {num_inputs} "
                f"files had a record at read {total_read + 1}"
            )
        total_read += 1
        if keep:
            total_kept += 1
        if total_read % log_unit == 0:
            pct = total_kept / total_read * 100.0
            logger.info(
                "[fqtk subsample] Read %s record sets and wrote %s (%.1f%%).",
                fmt_count(total_read),
                fmt_count(total_kept),
                pct,
            )

    logger.info("Finished reading input FASTQs.")
    for w in writers:
        w.close()
    for s in sources:
        s.close()

    pct = total_kept / total_read * 100.0 if total_read > 0 else 0.0
    logger.info(
        "[fqtk subsample] Read %s record sets and wrote %s (%.1f%%).",
        fmt_count(total_read),
        fmt_count(total_kept),
        pct,
    )
    return SubsampleResult(total_read=total_read, total_kept=total_kept, seed=seed)
