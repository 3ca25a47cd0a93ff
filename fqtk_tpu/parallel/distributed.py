"""Multi-host demultiplexing: data-parallel input shards + psum'd metrics.

The reference is single-process; its natural multi-host extension (SURVEY.md
§2c, §5) keeps the streaming pipeline per host and distributes *inputs*:

- Each host runs the full native demux pipeline over its own shard of the
  input (e.g. one lane's FASTQs per host, the pattern fqtk documents as
  "concatenate lanes before demuxing" — here each lane demuxes in parallel
  instead).
- Per-sample template counts are associative integer sums, so the global
  ``DemuxMetric`` values are computed exactly by summing per-host counts —
  a single ``psum`` over the hosts' device mesh — and writing ``demux-metrics.txt`` once on process 0.
- Per-sample FASTQ outputs are written per host under ``shard-{pid}/``; a
  global view is the in-order concatenation of shards, mirroring what the
  reference produces after lane concatenation.  (Byte-level equality with a
  single-process run over the concatenated input holds per shard.)  The
  merge that realizes this view is :mod:`fqtk_tpu.parallel.merge`
  (``demux --merge-output`` / ``fqtk-tpu concat-shards``).

Entry points:

- :func:`init_distributed` — ``jax.distributed.initialize`` wrapper.
- :func:`run_demux_multihost` — per-host pipeline + collective metric merge.
- :func:`merge_host_counts` — the collective itself (identity when running
  single-process, so the same code path runs everywhere).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

logger = logging.getLogger("fqtk")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the JAX multi-host runtime (no-op if already initialized)."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        # jax's double-init message is "distributed.initialize should only
        # be called once."; older versions said "already initialized"
        msg = str(e)
        if "already" not in msg and "once" not in msg:
            raise


def merge_host_counts(local_counts: np.ndarray) -> np.ndarray:
    """Sum per-sample template counts across all hosts.

    Built on ``multihost_utils.process_allgather`` — the canonical primitive
    for per-process host data: each process contributes its local vector
    exactly once (no replication-consistency assumption; each host's counts
    ARE different), the gather rides the runtime's cross-host collective
    channel, and the sum over the ``[n_process, ...]`` result is an
    exact integer reduction, so merged metrics equal a single-process run's.

    Exercised by a real 2-process ``jax.distributed`` run in
    ``tests/test_multiprocess.py``.
    """
    import jax

    if jax.process_count() == 1:
        return np.asarray(local_counts, dtype=np.int64)

    from jax.experimental import multihost_utils

    # Ship the int64 vector as its two int32 halves: without jax_enable_x64
    # (the default) jax silently downcasts int64 -> int32, which would
    # corrupt counts above 2^31.  Viewing preserves the bytes exactly and
    # all hosts share endianness within a slice.
    local64 = np.ascontiguousarray(np.asarray(local_counts, dtype=np.int64))
    halves = local64.view(np.int32).reshape(local64.shape + (2,))
    gathered = multihost_utils.process_allgather(halves)
    merged = np.asarray(gathered, dtype=np.int32)  # [n_process, K+1, 2]
    per_host = np.ascontiguousarray(merged).view(np.int64).reshape(
        merged.shape[:-1]
    )
    return per_host.sum(axis=0).astype(np.int64)


def run_demux_multihost(
    cfg,
    input_shards: Optional[Sequence[List]] = None,
    merge_output: bool = False,
):
    """Run demux across hosts: this process handles shard ``process_index``.

    ``input_shards``: optional per-host input lists (each entry is the
    ``inputs`` list for one host; all share the read structures).  When
    omitted, every host must already have its own ``cfg.inputs``.

    Outputs land in ``{cfg.output}/shard-{pid}/``; the merged
    ``demux-metrics.txt`` (global counts over all hosts) is written at
    ``{cfg.output}/demux-metrics.txt`` by process 0.  With
    ``merge_output=True`` process 0 additionally concatenates the shard
    FASTQs into single per-sample files (:func:`fqtk_tpu.parallel.merge.
    concat_shards`) — safe because the count collective below completes
    only after every host's local pipeline has finished and closed its
    writers, so it doubles as the end-of-write barrier.  This requires a
    shared filesystem across hosts (the usual POSIX-store deployment);
    without one, run ``fqtk-tpu concat-shards`` offline after copying the
    shard directories together.
    """
    import dataclasses

    import jax

    from ..core.samples import SampleGroup
    from ..runtime.demux import compute_metrics, run_demux, write_metrics

    pid = jax.process_index()
    nproc = jax.process_count()
    if input_shards is not None:
        if len(input_shards) != nproc:
            raise ValueError(
                f"{len(input_shards)} input shards for {nproc} processes"
            )
        inputs = list(input_shards[pid])
    else:
        inputs = list(cfg.inputs)

    shard_out = Path(cfg.output) / f"shard-{pid}"
    local_cfg = dataclasses.replace(cfg, inputs=inputs, output=shard_out)

    # Warm the cross-host collective CONCURRENTLY with the streaming
    # pipeline: the first process_allgather pays a one-time program
    # build/compile (~300 ms measured on the CPU backend), which showed up
    # as pure end-of-run latency on short jobs (scripts/scaling_bench.py
    # measured 0.65 coordination efficiency at 1M reads before this).
    # Every process issues the warmup gather first and the real merge
    # after the join, so the collective ordering stays consistent.
    import threading

    k_probe = len(SampleGroup.from_file(cfg.sample_metadata).samples)
    warm_exc = []

    def _warm():
        try:
            merge_host_counts(np.zeros(k_probe + 1, dtype=np.int64))
        except Exception as e:  # pragma: no cover - surfaced at join
            warm_exc.append(e)

    warm_thread = threading.Thread(target=_warm, daemon=True)
    warm_thread.start()

    result = run_demux(local_cfg)
    warm_thread.join()
    if warm_exc:
        raise warm_exc[0]

    sample_group = SampleGroup.from_file(cfg.sample_metadata)
    k = len(sample_group.samples)
    local_counts = np.zeros(k + 1, dtype=np.int64)
    for i, row in enumerate(result.metrics):
        local_counts[i] = row["templates"]

    global_counts = merge_host_counts(local_counts)
    metrics = compute_metrics(sample_group, global_counts, cfg.unmatched_prefix)
    if pid == 0:
        Path(cfg.output).mkdir(parents=True, exist_ok=True)
        write_metrics(Path(cfg.output) / "demux-metrics.txt", metrics)
        logger.info(
            "Merged metrics over %d host(s): %d templates",
            nproc,
            int(global_counts.sum()),
        )
        if merge_output:
            from .merge import concat_shards

            concat_shards(Path(cfg.output), expected_shards=nproc)
    return metrics
