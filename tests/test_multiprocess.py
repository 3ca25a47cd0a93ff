"""Real 2-process ``jax.distributed`` tests for the multi-host path.

Each test launches two fresh interpreters (CPU backend, 2 fake devices
each) that rendezvous through a jax.distributed coordinator, exactly as two
hosts would over the network.  This exercises ``merge_host_counts`` and
``run_demux_multihost`` in genuinely multi-process form — the
``process_count() == 1`` identity short-circuit never runs here.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).parent / "_mp_worker.py"
REPO = Path(__file__).parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(mode: str, workdir: Path, timeout: int = 180):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), mode, str(pid), "2", str(port), str(workdir)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            cwd=str(REPO),
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode("utf-8", "replace"))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    return outs


def test_merge_host_counts_two_processes(tmp_path):
    outs = _run_pair("merge_counts", tmp_path)
    # both processes computed the same exact integer sum
    for out in outs:
        assert "MERGE_OK" in out, out
    lines = [l for o in outs for l in o.splitlines() if l.startswith("MERGE_OK")]
    assert lines[0] == lines[1]


def test_run_demux_multihost_two_processes(tmp_path):
    # shard 0: 3 reads of sample A; shard 1: 2 reads of sample A + 1 unmatched
    def fq(path, bcs):
        lines = []
        for i, bc in enumerate(bcs):
            lines += [f"@r{path.stem}_{i}", bc + "GGGGG", "+", ";" * (len(bc) + 5)]
        path.write_text("\n".join(lines) + "\n")

    fq(tmp_path / "in0.fastq", ["GATTACA", "GATTACA", "GATTACA"])
    fq(tmp_path / "in1.fastq", ["GATTACA", "GATTACA", "TTTTTTT"])
    (tmp_path / "metadata.tsv").write_text("sample_id\tbarcode\nsA\tGATTACA\n")

    _run_pair("demux_multihost", tmp_path)

    metrics = json.loads((tmp_path / "metrics.json").read_text())
    by_id = {m["sample_id"]: m for m in metrics}
    assert by_id["sA"]["templates"] == 5  # merged over both hosts
    assert by_id["unmatched"]["templates"] == 1
    # global metrics file written once by process 0
    text = (tmp_path / "out" / "demux-metrics.txt").read_text()
    assert "sA\tGATTACA\t5" in text
    # per-host outputs exist under shard dirs
    assert (tmp_path / "out" / "shard-0" / "sA.R1.fq.gz").exists()
    assert (tmp_path / "out" / "shard-1" / "sA.R1.fq.gz").exists()


def test_cli_distributed_demux_two_processes(tmp_path):
    """`fqtk-tpu demux --distributed-coordinator ...` runs the full
    multi-host path from the command line: per-process shard outputs plus
    one exactly-merged global metrics file."""

    def fq(path, bcs):
        lines = []
        for i, bc in enumerate(bcs):
            lines += [f"@r{path.stem}_{i}", bc + "GGGGG", "+", ";" * (len(bc) + 5)]
        path.write_text("\n".join(lines) + "\n")

    fq(tmp_path / "in0.fastq", ["GATTACA"] * 4)
    fq(tmp_path / "in1.fastq", ["GATTACA", "TTTTTTT"])
    (tmp_path / "metadata.tsv").write_text("sample_id\tbarcode\nsA\tGATTACA\n")

    _run_pair("demux_cli", tmp_path)

    text = (tmp_path / "out" / "demux-metrics.txt").read_text()
    assert "sA\tGATTACA\t5" in text
    assert (tmp_path / "out" / "shard-0" / "sA.R1.fq.gz").exists()
    assert (tmp_path / "out" / "shard-1" / "sA.R1.fq.gz").exists()
    # --merge-output: process 0 merged the shards into root-level files whose
    # decompressed contents are the in-order shard concatenation
    import gzip

    for name in ("sA.R1.fq.gz", "unmatched.R1.fq.gz"):
        merged = gzip.decompress((tmp_path / "out" / name).read_bytes())
        sharded = b"".join(
            gzip.decompress((tmp_path / "out" / f"shard-{p}" / name).read_bytes())
            for p in range(2)
        )
        assert merged == sharded, name


def test_multihost_shards_concatenate_to_single_process_output(tmp_path):
    """The documented global view of multi-host output — per-sample shard
    files concatenated in shard order — must equal a single-process run
    over the concatenated inputs, byte for byte."""
    import gzip

    def fq(path, bcs):
        lines = []
        for i, bc in enumerate(bcs):
            lines += [f"@{path.stem}_{i} 1:N:0:0", bc + "GGGGG", "+", ";" * (len(bc) + 5)]
        path.write_text("\n".join(lines) + "\n")

    shard0 = ["GATTACA", "GATTACA", "TTTTTTT", "GATTACA"]
    shard1 = ["GATTACA", "CCCCCCC", "GATTACA"]
    fq(tmp_path / "in0.fastq", shard0)
    fq(tmp_path / "in1.fastq", shard1)
    (tmp_path / "metadata.tsv").write_text("sample_id\tbarcode\nsA\tGATTACA\n")

    _run_pair("demux_multihost", tmp_path)

    # single-process over the concatenated input
    combined = tmp_path / "combined.fastq"
    combined.write_text(
        (tmp_path / "in0.fastq").read_text() + (tmp_path / "in1.fastq").read_text()
    )
    from fqtk_tpu.runtime.demux import DemuxConfig, run_demux

    run_demux(
        DemuxConfig(
            inputs=[combined],
            read_structures=["7B+T"],
            sample_metadata=tmp_path / "metadata.tsv",
            output=tmp_path / "single",
            engine="numpy",
            batch_size=4,
        )
    )
    for name in ("sA.R1.fq.gz", "unmatched.R1.fq.gz"):
        sharded = b"".join(
            gzip.decompress((tmp_path / "out" / f"shard-{p}" / name).read_bytes())
            for p in range(2)
        )
        single = gzip.decompress((tmp_path / "single" / name).read_bytes())
        assert sharded == single, name
    # and the merged metrics equal the single-process metrics
    assert (tmp_path / "out" / "demux-metrics.txt").read_text() == (
        tmp_path / "single" / "demux-metrics.txt"
    ).read_text()
