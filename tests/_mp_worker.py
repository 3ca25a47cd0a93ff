"""Worker for the 2-process jax.distributed tests (not a pytest module).

Usage: python _mp_worker.py <mode> <pid> <nproc> <port> <workdir>
"""

import json
import sys
from pathlib import Path

# Run as a bare script (`python tests/_mp_worker.py`), so sys.path[0] is
# tests/ — make the repo root importable regardless of install state.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    mode, pid, nproc, port, workdir = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
        sys.argv[5],
    )
    import jax

    # Config-based setup (the parent's environment may already name another
    # platform, and jax reads it at import).  Multi-process
    # CPU clients need the gloo collectives backend; without it each process
    # builds a local-only client and process_count() stays 1.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    if mode != "demux_cli":  # the CLI mode initializes via --distributed-*
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nproc,
            process_id=pid,
        )
        assert jax.process_count() == nproc, jax.process_count()

    import numpy as np

    if mode == "merge_counts":
        from fqtk_tpu.parallel.distributed import merge_host_counts

        local = np.arange(7, dtype=np.int64) + pid * 100
        # counts above 2^31 must survive the gather exactly (jax without
        # x64 silently downcasts int64 -> int32; the merge ships halves)
        local[3] = (1 << 40) + pid
        merged = merge_host_counts(local)
        expected = sum(np.arange(7, dtype=np.int64) + p * 100 for p in range(nproc))
        expected[3] = sum((1 << 40) + p for p in range(nproc))
        assert np.array_equal(merged, expected), (merged, expected)
        print("MERGE_OK", merged.tolist())
        return 0

    if mode == "demux_multihost":
        from pathlib import Path

        from fqtk_tpu.parallel.distributed import run_demux_multihost
        from fqtk_tpu.runtime.demux import DemuxConfig

        wd = Path(workdir)
        cfg = DemuxConfig(
            inputs=[wd / f"in{pid}.fastq"],
            read_structures=["7B+T"],
            sample_metadata=wd / "metadata.tsv",
            output=wd / "out",
            engine="numpy",
            batch_size=4,
        )
        shards = [[wd / f"in{p}.fastq"] for p in range(nproc)]
        metrics = run_demux_multihost(cfg, input_shards=shards)
        if pid == 0:
            (wd / "metrics.json").write_text(json.dumps(metrics))
        print("DEMUX_OK")
        return 0

    if mode == "demux_cli":
        from pathlib import Path

        from fqtk_tpu.cli import main as cli_main

        wd = Path(workdir)
        rc = cli_main(
            [
                "demux",
                "-i", str(wd / f"in{pid}.fastq"),
                "-r", "7B+T",
                "-s", str(wd / "metadata.tsv"),
                "-o", str(wd / "out"),
                "--engine", "numpy",
                "--batch-size", "4",
                "--distributed-coordinator", f"localhost:{port}",
                "--num-processes", str(nproc),
                "--process-id", str(pid),
                "--merge-output",
            ]
        )
        assert rc == 0
        print("CLI_DEMUX_OK")
        return 0

    raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    sys.exit(main())
