"""Measured multi-process scaling (BASELINE north star).

A real multi-host cluster is not assumed, so this measures what runs on
one machine: the same total input demuxed by

  A. one standalone process, vs
  B. two ``jax.distributed`` CPU processes (gloo collectives, split inputs,
     shard outputs + metric allgather — the production multi-host path).

Two framings, because a single 4-core box conflates two questions:

1. **Coordination overhead** (the honest multi-host proxy): each side gets
   the SAME per-process resources (2 pinned cores, half the input).
   ``eff_overhead = T_solo / T_dist`` isolates what jax.distributed init,
   the rendezvous, and the final O(1) count collective cost on top of a
   share-nothing pipeline — on real hosts each process owns its machine,
   so this is the term that scales.
2. **Same-box throughput**: one process on all 4 cores over the full input
   vs the 2x2-core distributed pair on the same total input.
   ``eff_samebox = T_1proc / T_dist`` — both sides own 4 cores total, so
   perfect intra-host scaling gives 1.0; CPU contention (shared LLC/DRAM,
   doubled compressor pools) is the expected loss and is NOT present
   across real hosts.

Writes the result JSON to stdout (and SCALING_LOCAL.json at the repo root).

Run: python scripts/scaling_bench.py [reads_per_shard]
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def write_shard(tmp, barcodes, n_reads, name, seed):
    import gzip

    rng = np.random.default_rng(seed)
    length = len(barcodes[0])
    choices = rng.integers(0, len(barcodes), size=n_reads)
    path = tmp / f"{name}.fq.gz"
    tmpl = ("ACGT" * 25).encode()
    chunk = 100_000
    with gzip.open(path, "wb", compresslevel=1) as fh:
        for lo in range(0, n_reads, chunk):
            hi = min(lo + chunk, n_reads)
            parts = []
            for i in range(lo, hi):
                seq = barcodes[choices[i]].encode() + tmpl
                parts.append(
                    b"@inst:1:AB:1:2:%d:3 1:N:0:0\n%s\n+\n%s\n"
                    % (i, seq, b"I" * len(seq))
                )
            fh.write(b"".join(parts))
    return path, length


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


WORKER_SRC = r'''
import sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[6])

def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    shard, outdir, repo, meta, threads = (
        sys.argv[4], sys.argv[5], sys.argv[6], sys.argv[7], int(sys.argv[8])
    )
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 1)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    from fqtk_tpu.parallel.distributed import run_demux_multihost
    from fqtk_tpu.runtime.demux import DemuxConfig
    shards = [[Path(shard)], [Path(shard).with_name("shard1.fq.gz")]]
    cfg = DemuxConfig(
        inputs=[],
        read_structures=["17B+T"],
        sample_metadata=Path(meta),
        output=Path(outdir),
        threads=threads,
        engine="native",
    )
    t0 = time.perf_counter()
    run_demux_multihost(cfg, input_shards=shards)
    print(f"WALL {time.perf_counter() - t0:.3f}")
    return 0

sys.exit(main())
'''


def run_distributed(tmp, shard0, meta, threads, pin):
    port = _free_port()
    worker = tmp / "worker.py"
    worker.write_text(WORKER_SRC)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for pid in range(2):
        argv = [
            sys.executable, str(worker), str(pid), "2", str(port),
            str(shard0), str(tmp / f"out_dist"), str(REPO), str(meta),
            str(threads),
        ]
        if pin:
            argv = ["taskset", "-c", "0,1" if pid == 0 else "2,3"] + argv
        procs.append(
            subprocess.Popen(
                argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env, cwd=str(REPO),
            )
        )
    walls = []
    for p in procs:
        out, _ = p.communicate(timeout=1200)
        text = out.decode("utf-8", "replace")
        assert p.returncode == 0, text[-2000:]
        walls.append(float(text.split("WALL ")[-1].split()[0]))
    return max(walls)


def run_solo(tmp, inputs, meta, threads, pin, tag):
    """Standalone single process via a subprocess (so taskset pinning and
    interpreter startup conditions match the distributed runs)."""
    src = (
        "import sys, time; from pathlib import Path\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from fqtk_tpu.runtime.demux import DemuxConfig, run_demux\n"
        f"cfg = DemuxConfig(inputs=[Path(p) for p in {list(map(str, inputs))!r}],\n"
        "    read_structures=['17B+T'] * "
        f"{len(inputs)},\n"
        f"    sample_metadata=Path({str(meta)!r}), output=Path({str(tmp / ('out_' + tag))!r}),\n"
        f"    threads={threads}, engine='native')\n"
        "t0 = time.perf_counter(); run_demux(cfg)\n"
        "print(f'WALL {time.perf_counter() - t0:.3f}')\n"
    )
    script = tmp / f"solo_{tag}.py"
    script.write_text(src)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    argv = [sys.executable, str(script)]
    if pin:
        argv = ["taskset", "-c", pin] + argv
    out = subprocess.run(
        argv, capture_output=True, env=env, cwd=str(REPO), timeout=1200
    )
    text = out.stdout.decode() + out.stderr.decode()
    assert out.returncode == 0, text[-2000:]
    return float(text.split("WALL ")[-1].split()[0])


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    barcodes = []
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seen = set()
    while len(barcodes) < 16:
        bc = bytes(rng.choice(bases, size=17)).decode()
        if bc not in seen:
            seen.add(bc)
            barcodes.append(bc)
    have_taskset = subprocess.run(
        ["which", "taskset"], capture_output=True
    ).returncode == 0 and (os.cpu_count() or 0) >= 4

    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        meta = tmp / "meta.tsv"
        meta.write_text(
            "sample_id\tbarcode\n"
            + "".join(f"S{i:02d}\t{b}\n" for i, b in enumerate(barcodes))
        )
        print(f"generating 2 x {n} reads ...", file=sys.stderr)
        shard0, _ = write_shard(tmp, barcodes, n, "shard0", seed=11)
        shard1, _ = write_shard(tmp, barcodes, n, "shard1", seed=22)

        # interleave A/B/A/B to split VM noise fairly
        t_solo = t_dist = float("inf")
        t_1proc = float("inf")
        for trial in range(2):
            t_solo = min(
                t_solo,
                run_solo(tmp, [shard0], meta, threads=5,
                         pin="0,1" if have_taskset else None,
                         tag=f"solo{trial}"),
            )
            t_dist = min(
                t_dist,
                run_distributed(tmp, shard0, meta, threads=5,
                                pin=have_taskset),
            )
            t_1proc = min(
                t_1proc,
                run_solo(tmp, [shard0], meta, threads=8, pin=None,
                         tag=f"full{trial}"),
            )

        result = {
            "metric": "multiprocess_scaling",
            "reads_per_shard": n,
            "pinned_cores": bool(have_taskset),
            "solo_2core_shard_s": round(t_solo, 3),
            "dist_2x2core_shard_each_s": round(t_dist, 3),
            "coordination_efficiency": round(t_solo / t_dist, 4),
            "oneproc_4core_shard_s": round(t_1proc, 3),
            "samebox_2proc_vs_1proc_throughput": round(
                (2 * n / t_dist) / (n / t_1proc), 4
            ),
            "note": "coordination_efficiency = same per-process resources "
            "(2 pinned cores, 1 shard) standalone vs under jax.distributed "
            "with the O(1) count collective — the term that survives on "
            "real multi-host; samebox ratio divides 4 shared cores between "
            "2 processes (contention that separate hosts don't have)",
        }
        print(json.dumps(result))
        (REPO / "SCALING_LOCAL.json").write_text(json.dumps(result, indent=1) + "\n")


if __name__ == "__main__":
    main()
