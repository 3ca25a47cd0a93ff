"""Flag-compatible command line: ``fqtk-tpu <demux|subsample> [flags]``.

Mirrors the reference CLI surface (``/root/reference/src/bin/main.rs`` plus
the clap derives at ``demux.rs:597-652`` and ``subsample.rs:57-90``): same
subcommands, flags, short options, and defaults.  Engine-specific extensions
(batch size, compute engine) are added under ``--`` long names that do not
collide with the reference.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import List, Optional

from . import __version__


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fqtk-tpu",
        description="FASTQ toolkit: sample demultiplexing and subsampling",
    )
    parser.add_argument("--version", action="version", version=f"fqtk-tpu {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    demux = sub.add_parser(
        "demux",
        help="Performs sample demultiplexing on FASTQs.",
        description=(
            "Performs sample demultiplexing on FASTQs. The sample barcode for "
            "each sample in the metadata TSV is compared against the sample "
            "barcode bases extracted from the FASTQs to assign each read to a "
            "sample; reads that do not match any sample within the given "
            "error tolerance are placed in the unmatched-prefix files."
        ),
    )
    demux.add_argument(
        "--inputs", "-i", nargs="+", required=True, type=Path,
        help="One or more input FASTQ files each corresponding to a "
        "sequencing read (e.g. R1, I1).",
    )
    demux.add_argument(
        "--read-structures", "-r", nargs="+", required=True,
        help="The read structures, one per input FASTQ in the same order.",
    )
    demux.add_argument(
        "--output-types", "-b", nargs="+", default=["T"],
        help="The read structure types to write to their own files (one of "
        "T, B, M, or C for template, sample barcode, molecular barcode, or "
        "cellular barcode reads).",
    )
    demux.add_argument(
        "--sample-metadata", "-s", required=True, type=Path,
        help="A file containing the metadata about the samples (headered "
        "TSV with sample_id and barcode columns).",
    )
    demux.add_argument(
        "--output", "-o", required=True, type=Path,
        help="The output directory into which to write per-sample FASTQs.",
    )
    demux.add_argument(
        "--unmatched-prefix", "-u", default="unmatched",
        help="Output prefix for FASTQ file(s) for reads that cannot be "
        "matched to a sample.",
    )
    demux.add_argument(
        "--max-mismatches", type=int, default=1,
        help="Maximum mismatches for a barcode to be considered a match.",
    )
    demux.add_argument(
        "--min-mismatch-delta", "-d", type=int, default=2,
        help="Minimum difference between number of mismatches in the best "
        "and second best barcodes for a barcode to be considered a match.",
    )
    demux.add_argument(
        "--threads", "-t", type=int, default=8,
        help="The number of threads to use. Cannot be less than 5.",
    )
    demux.add_argument(
        "--compression-level", "-c", type=int, default=5,
        help="The level of compression to use to compress outputs.",
    )
    demux.add_argument(
        # nargs="+": a bare -S must be a parse error like clap's
        # Vec<SkipReason> (an empty list would silently disable skipping)
        "--skip-reasons", "-S", nargs="+", default=[],
        help="Skip demultiplexing reads for any of the following reasons, "
        "otherwise panic: 'too-few-bases' (too few bases/qualities to "
        "extract given the read structures).",
    )
    # engine extensions (not in the reference CLI)
    demux.add_argument(
        "--batch-size", type=int, default=1 << 17,
        help="Reads per device batch (engine extension).",
    )
    demux.add_argument(
        "--engine",
        choices=["auto", "native", "jax", "numpy"],
        default="auto",
        help="Compute engine: auto = native (C++ host I/O + device or host "
        "matcher; built on first use, an error if it cannot be); jax and "
        "numpy are the Python-I/O reference engines (engine extension).",
    )
    demux.add_argument(
        "--matcher",
        choices=["auto", "host", "device"],
        default="auto",
        help="Assignment placement: auto measures one host window against "
        "one device round-trip at the production batch and picks the "
        "faster side (decision cached on disk; FQTK_HOST_MATCHER_MAX_K "
        "pins a static whitelist-size crossover instead), huge whitelists "
        "use the host pigeonhole matcher (engine extension).",
    )
    # per-subcommand --version, as clap's #[command(version)] provides
    demux.add_argument(
        "--version", action="version", version=f"fqtk-tpu demux {__version__}"
    )
    demux.add_argument(
        "--devices",
        type=int,
        default=None,
        help="Device-mesh size for the matcher: default all local devices "
        "(batch-parallel; whitelist-sharded for huge sample sets), 1 forces "
        "single-device (engine extension).",
    )
    demux.add_argument(
        "--distributed-coordinator",
        default=None,
        metavar="HOST:PORT",
        help="Multi-host mode: jax.distributed coordinator address.  Each "
        "process demuxes its own --inputs shard into "
        "{output}/shard-{process_id}/ and the global demux-metrics.txt is "
        "merged exactly across hosts (engine extension).",
    )
    demux.add_argument(
        "--num-processes", type=int, default=None,
        help="Multi-host mode: total process count.",
    )
    demux.add_argument(
        "--process-id", type=int, default=None,
        help="Multi-host mode: this process's id (0-based).",
    )
    demux.add_argument(
        "--merge-output", action="store_true",
        help="Multi-host mode: after all hosts finish, process 0 merges the "
        "shard-N directories into single per-sample files at the output "
        "root (BGZF block concatenation; also available offline as the "
        "concat-shards subcommand) (engine extension).",
    )

    cs = sub.add_parser(
        "concat-shards",
        help="Merges a multi-host demux output's shard-N directories into "
        "single per-sample FASTQs.",
        description=(
            "Merges {output}/shard-N/*.fq.gz (written by demux "
            "--distributed-coordinator) into single per-sample files at the "
            "output root. BGZF blocks are concatenated without "
            "recompression; the merged files' decompressed contents are "
            "identical to a single-process run over the concatenated "
            "inputs."
        ),
    )
    cs.add_argument(
        "--output", "-o", required=True, type=Path,
        help="The demux output directory containing shard-N subdirectories.",
    )
    cs.add_argument(
        "--remove-shards", action="store_true",
        help="Delete the shard-N directories after a successful merge.",
    )
    cs.add_argument(
        "--version", action="version",
        version=f"fqtk-tpu concat-shards {__version__}",
    )

    ss = sub.add_parser(
        "subsample", help="Subsamples reads from one or more synchronized FASTQ files."
    )
    ss.add_argument(
        "--inputs", "-i", nargs="+", required=True, type=Path,
        help="One or more input FASTQ files (may be gzipped). All files must "
        "have the same number of reads in the same order.",
    )
    ss.add_argument(
        "--output", "-o", required=True, type=Path,
        help="Output path prefix. Files will be named {output}.R1.fq.gz, etc.",
    )
    ss.add_argument(
        "--fraction", "-f", type=float, required=True,
        help="Fraction of reads to retain, in the range [0.0, 1.0].",
    )
    ss.add_argument(
        "--threads", "-t", type=int, default=8,
        help="Number of threads for compression. Minimum 2.",
    )
    ss.add_argument(
        "--compression-level", "-c", type=int, default=5,
        help="BGZF compression level for output files.",
    )
    ss.add_argument(
        "--seed",
        "-s",
        type=int,
        default=None,
        help=(
            "Explicit RNG seed for reproducibility; with a seed the keep/drop "
            "mask matches fqtk bit-for-bit.  When omitted a deterministic "
            "seed is derived from all other parameters via the reference's "
            "DefaultHasher (SipHash-1-3) derivation."
        ),
    )
    ss.add_argument(
        "--version", action="version", version=f"fqtk-tpu subsample {__version__}"
    )
    ss.add_argument(
        "--disable-read-name-checking", action="store_true",
        help="Disable checking that read names are in sync across input files.",
    )
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s] %(levelname)s %(name)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    args = _build_parser().parse_args(argv)
    from .utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    try:
        return _dispatch(args)
    except Exception as e:  # clean operator-facing errors, like the reference CLI
        print(f"Error: {e}", file=sys.stderr)
        return 1


def _dispatch(args) -> int:
    if args.command == "demux":
        from .runtime.demux import DemuxConfig, run_demux

        cfg = DemuxConfig(
            inputs=list(args.inputs),
            read_structures=list(args.read_structures),
            sample_metadata=args.sample_metadata,
            output=args.output,
            output_types=list(args.output_types),
            unmatched_prefix=args.unmatched_prefix,
            max_mismatches=args.max_mismatches,
            min_mismatch_delta=args.min_mismatch_delta,
            threads=args.threads,
            compression_level=args.compression_level,
            skip_reasons=list(args.skip_reasons),
            batch_size=args.batch_size,
            engine=args.engine,
            devices=args.devices,
            matcher=args.matcher,
        )
        if args.distributed_coordinator is not None:
            from .parallel.distributed import init_distributed, run_demux_multihost

            init_distributed(
                coordinator_address=args.distributed_coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id,
            )
            run_demux_multihost(cfg, merge_output=args.merge_output)
            return 0
        if args.merge_output:
            raise ValueError(
                "--merge-output requires --distributed-coordinator (a "
                "single-process run already writes single per-sample files)"
            )
        run_demux(cfg)
        return 0
    if args.command == "concat-shards":
        from .parallel.merge import concat_shards

        concat_shards(args.output, remove_shards=args.remove_shards)
        return 0
    if args.command == "subsample":
        from .runtime.subsample import SubsampleConfig, run_subsample

        cfg = SubsampleConfig(
            inputs=list(args.inputs),
            output=args.output,
            fraction=args.fraction,
            threads=args.threads,
            compression_level=args.compression_level,
            seed=args.seed,
            disable_read_name_checking=args.disable_read_name_checking,
        )
        run_subsample(cfg)
        return 0
    return 2  # pragma: no cover


if __name__ == "__main__":
    sys.exit(main())
