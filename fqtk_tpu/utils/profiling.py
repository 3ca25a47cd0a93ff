"""Per-stage pipeline timing + optional device traces (SURVEY.md §5).

The reference has no tracing; this build exposes:

- :class:`StageTimers` — cumulative wall-clock per pipeline stage (parse,
  assign dispatch, result fetch, route, finish), logged at the end of a run
  and returned in ``DemuxResult.timings``.
- ``FQTK_PROFILE_DIR`` — when set, wraps the run in a ``jax.profiler`` trace
  written to that directory (viewable with TensorBoard / xprof).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

logger = logging.getLogger("fqtk")


class StageTimers:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - t0
            self.counts[stage] += 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def log(self, total_records: int) -> None:
        if not self.totals:
            return
        parts = []
        for stage, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            rate = total_records / t if t > 0 else float("inf")
            parts.append(f"{stage}={t:.2f}s ({rate / 1e6:.2f}M/s)")
        logger.info("pipeline stage times (wall, overlapped): %s", ", ".join(parts))


@contextlib.contextmanager
def maybe_device_trace() -> Iterator[None]:
    """jax.profiler trace when FQTK_PROFILE_DIR is set."""
    trace_dir = os.environ.get("FQTK_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
    logger.info("device trace written to %s", trace_dir)
