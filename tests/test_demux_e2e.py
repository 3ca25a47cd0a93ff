"""End-to-end demux tests mirroring the reference's integration scenarios
(``/root/reference/src/bin/commands/demux.rs:1099-2073``), run through both
the numpy and jax engines."""

import gzip

import pytest

from fqtk_tpu.runtime.demux import DemuxConfig, DemuxError, run_demux

from .util import (
    SAMPLE1_BARCODE,
    assert_records,
    fastq_file,
    metadata,
    metadata_file,
)

ENGINES = ["numpy", "jax", "native"]


def _cfg(tmp_path, inputs, read_structures, sample_metadata, output, engine, **kw):
    defaults = dict(
        output_types=["T"],
        unmatched_prefix="unmatched",
        max_mismatches=1,
        min_mismatch_delta=2,
        threads=5,
        compression_level=5,
        skip_reasons=[],
        batch_size=7,  # small to exercise batching paths
        engine=engine,
    )
    defaults.update(kw)
    return DemuxConfig(
        inputs=inputs,
        read_structures=read_structures,
        sample_metadata=sample_metadata,
        output=output,
        **defaults,
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_validate_inputs_can_succeed(tmp_path, engine):
    inputs = [
        fastq_file(tmp_path, "read1", "ex", ["GATTACA"]),
        fastq_file(tmp_path, "read2", "ex", ["TAGGATTA"]),
        fastq_file(tmp_path, "index1", "ex", [SAMPLE1_BARCODE[0:3]]),
        fastq_file(tmp_path, "index2", "ex", [SAMPLE1_BARCODE[3:]]),
    ]
    cfg = _cfg(
        tmp_path,
        inputs,
        ["+T", "+T", "+B", "+B"],
        metadata(tmp_path),
        tmp_path,
        engine,
    )
    run_demux(cfg)


def test_different_number_of_read_structs_and_inputs_fails(tmp_path):
    inputs = [
        fastq_file(tmp_path, "read1", "ex", ["GATTACA"]),
        fastq_file(tmp_path, "read2", "ex", ["TAGGATTA"]),
        fastq_file(tmp_path, "index1", "ex", [SAMPLE1_BARCODE[0:3]]),
        fastq_file(tmp_path, "index2", "ex", [SAMPLE1_BARCODE[3:]]),
    ]
    cfg = _cfg(
        tmp_path, inputs, ["+T", "+T", "+B"], metadata(tmp_path), tmp_path, "numpy"
    )
    with pytest.raises(
        DemuxError, match="The same number of read structures should be given as FASTQs"
    ):
        run_demux(cfg)


def test_inputs_doesnt_exist_fails(tmp_path):
    inputs = [
        tmp_path / "this_file_does_not_exist.fq",
        fastq_file(tmp_path, "read2", "ex", ["TAGGATTA"]),
    ]
    cfg = _cfg(tmp_path, inputs, ["+T", "+T"], metadata(tmp_path), tmp_path, "numpy")
    with pytest.raises(DemuxError, match="doesn't exist"):
        run_demux(cfg)


def test_too_few_threads_fails(tmp_path):
    inputs = [fastq_file(tmp_path, "read1", "ex", ["GATTACA"])]
    cfg = _cfg(
        tmp_path, inputs, ["+T"], metadata(tmp_path), tmp_path, "numpy", threads=2
    )
    with pytest.raises(DemuxError, match="Threads provided 2 was too low!"):
        run_demux(cfg)


def test_no_output_types_fails(tmp_path):
    inputs = [fastq_file(tmp_path, "read1", "ex", ["GATTACA"])]
    cfg = _cfg(
        tmp_path, inputs, ["+T"], metadata(tmp_path), tmp_path, "numpy", output_types=[]
    )
    with pytest.raises(DemuxError, match="No output types requested"):
        run_demux(cfg)


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_fragment_reads(tmp_path, engine):
    s1_barcode = "AAAAAAAAGATTACAGA"
    sample_metadata = metadata_file(
        tmp_path,
        [s1_barcode, "CCCCCCCCGATTACAGA", "GGGGGGGGGATTACAGA", "GGGGGGTTGATTACAGA"],
    )
    inputs = [fastq_file(tmp_path, "ex", "ex", [s1_barcode + "A" * 100])]
    out = tmp_path / "output"
    run_demux(_cfg(tmp_path, inputs, ["17B100T"], sample_metadata, out, engine))
    assert_records(
        out / "Sample0000.R1.fq.gz",
        [(b"ex_0 1:N:0:AAAAAAAAGATTACAGA", b"A" * 100, b";" * 100)],
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_output_type_reads(tmp_path, engine):
    sample_metadata = metadata_file(
        tmp_path, ["AAAAAAAA", "CCCCCCCC", "GGGGGGGG", "TTTTTTTT"]
    )
    inputs = [
        fastq_file(
            tmp_path, "ex", "ex", ["ATCGATCGAT" + "AAAAAAAA" + "GATTACA" + "A" * 100]
        )
    ]
    out = tmp_path / "output"
    run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["10M8B7C100T"],
            sample_metadata,
            out,
            engine,
            output_types=["T", "B", "M", "C"],
        )
    )
    head = b"ex_0:ATCGATCGAT 1:N:0:AAAAAAAA"
    assert_records(out / "Sample0000.R1.fq.gz", [(head, b"A" * 100, b";" * 100)])
    assert_records(out / "Sample0000.I1.fq.gz", [(head, b"AAAAAAAA", b";" * 8)])
    assert_records(out / "Sample0000.U1.fq.gz", [(head, b"ATCGATCGAT", b";" * 10)])
    assert_records(out / "Sample0000.C1.fq.gz", [(head, b"GATTACA", b";" * 7)])


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_with_catchall_barcode(tmp_path, engine):
    sample_metadata = metadata_file(tmp_path, ["NNNNNNN"])
    inputs = [fastq_file(tmp_path, "ex", "ex", ["NNNNNNN" + "A" * 100])]
    out = tmp_path / "output"
    run_demux(
        _cfg(tmp_path, inputs, ["7B+T"], sample_metadata, out, engine, max_mismatches=0)
    )
    assert_records(out / "unmatched.R1.fq.gz", [])
    assert_records(
        out / "Sample0000.R1.fq.gz",
        [(b"ex_0 1:N:0:NNNNNNN", b"A" * 100, b";" * 100)],
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_with_iupac_bases_in_barcode(tmp_path, engine):
    sample_metadata = metadata_file(tmp_path, ["MMMMMMM", "KKKKKKK"])
    inputs = [
        fastq_file(
            tmp_path,
            "ex",
            "ex",
            [
                "AAAAAAA" + "A" * 5,
                "CCCCCCC" + "A" * 5,
                "ACACACA" + "A" * 5,
                "GTGTGTG" + "C" * 5,
                "TGTGTGT" + "C" * 5,
                "CGCGCGC" + "T" * 5,
            ],
        )
    ]
    out = tmp_path / "output"
    run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["7B+T"],
            sample_metadata,
            out,
            engine,
            max_mismatches=0,
            min_mismatch_delta=0,
        )
    )
    assert_records(
        out / "Sample0000.R1.fq.gz",
        [
            (b"ex_0 1:N:0:AAAAAAA", b"A" * 5, b";" * 5),
            (b"ex_1 1:N:0:CCCCCCC", b"A" * 5, b";" * 5),
            (b"ex_2 1:N:0:ACACACA", b"A" * 5, b";" * 5),
        ],
    )
    assert_records(
        out / "Sample0001.R1.fq.gz",
        [
            (b"ex_3 1:N:0:GTGTGTG", b"C" * 5, b";" * 5),
            (b"ex_4 1:N:0:TGTGTGT", b"C" * 5, b";" * 5),
        ],
    )
    assert_records(
        out / "unmatched.R1.fq.gz",
        [(b"ex_5 1:N:0:CGCGCGC", b"T" * 5, b";" * 5)],
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_with_ns_in_barcode(tmp_path, engine):
    sample_metadata = metadata_file(tmp_path, ["NNAAAAA", "NNCCCCC"])
    inputs = [
        fastq_file(
            tmp_path,
            "ex",
            "ex",
            ["ANAAAAA" + "A" * 5, "ANCCCCC" + "C" * 5, "NNNAAAA" + "T" * 5],
        )
    ]
    out = tmp_path / "output"
    run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["7B+T"],
            sample_metadata,
            out,
            engine,
            max_mismatches=0,
            min_mismatch_delta=0,
        )
    )
    assert_records(
        out / "Sample0000.R1.fq.gz", [(b"ex_0 1:N:0:ANAAAAA", b"A" * 5, b";" * 5)]
    )
    assert_records(
        out / "Sample0001.R1.fq.gz", [(b"ex_1 1:N:0:ANCCCCC", b"C" * 5, b";" * 5)]
    )
    assert_records(
        out / "unmatched.R1.fq.gz", [(b"ex_2 1:N:0:NNNAAAA", b"T" * 5, b";" * 5)]
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_paired_reads_with_in_line_sample_barcodes(tmp_path, engine):
    s1 = "AAAAAAAAGATTACAGA"
    sample_metadata = metadata_file(
        tmp_path, [s1, "CCCCCCCCGATTACAGA", "GGGGGGGGGATTACAGA", "GGGGGGTTGATTACAGA"]
    )
    inputs = [
        fastq_file(tmp_path, "ex_R1", "ex", [s1[:8] + "A" * 100]),
        fastq_file(tmp_path, "ex_R2", "ex", [s1[8:] + "T" * 100]),
    ]
    out = tmp_path / "output"
    run_demux(_cfg(tmp_path, inputs, ["8B100T", "9B100T"], sample_metadata, out, engine))
    assert_records(
        out / "Sample0000.R1.fq.gz",
        [(b"ex_0 1:N:0:AAAAAAAA+GATTACAGA", b"A" * 100, b";" * 100)],
    )
    assert_records(
        out / "Sample0000.R2.fq.gz",
        [(b"ex_0 2:N:0:AAAAAAAA+GATTACAGA", b"T" * 100, b";" * 100)],
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_dual_indexed_paired_end_reads(tmp_path, engine):
    s1 = "AAAAAAAAGATTACAGA"
    sample_metadata = metadata_file(
        tmp_path, [s1, "CCCCCCCCGATTACAGA", "GGGGGGGGGATTACAGA", "GGGGGGTTGATTACAGA"]
    )
    inputs = [
        fastq_file(tmp_path, "ex_I1", "ex", [s1[:8]]),
        fastq_file(tmp_path, "ex_R1", "ex", ["A" * 100]),
        fastq_file(tmp_path, "ex_R2", "ex", ["T" * 100]),
        fastq_file(tmp_path, "ex_I2", "ex", [s1[8:]]),
    ]
    out = tmp_path / "output"
    run_demux(
        _cfg(tmp_path, inputs, ["8B", "100T", "100T", "9B"], sample_metadata, out, engine)
    )
    assert_records(
        out / "Sample0000.R1.fq.gz",
        [(b"ex_0 1:N:0:AAAAAAAA+GATTACAGA", b"A" * 100, b";" * 100)],
    )
    assert_records(
        out / "Sample0000.R2.fq.gz",
        [(b"ex_0 2:N:0:AAAAAAAA+GATTACAGA", b"T" * 100, b";" * 100)],
    )


def test_demux_native_without_jax_falls_back_to_numpy_spec(tmp_path, monkeypatch):
    """jax is an optional extra: on a jax-less host the native engine must
    still demux correctly (assignment via the NumPy spec) when no host
    matcher qualifies (FQTK_HOST_MATCHER_MAX_K=0 forces the device branch)."""
    import sys

    from fqtk_tpu.io import native as native_io

    if not native_io.available():
        pytest.skip("native library unavailable")
    monkeypatch.setenv("FQTK_HOST_MATCHER_MAX_K", "0")
    monkeypatch.setitem(sys.modules, "jax", None)  # import jax -> ImportError
    s1 = "AAAAAAAAGATTACAGA"
    sample_metadata = metadata_file(
        tmp_path, [s1, "CCCCCCCCGATTACAGA", "GGGGGGGGGATTACAGA", "GGGGGGTTGATTACAGA"]
    )
    inputs = [
        fastq_file(tmp_path, "ex_I1", "ex", [s1[:8]]),
        fastq_file(tmp_path, "ex_R1", "ex", ["A" * 100]),
        fastq_file(tmp_path, "ex_R2", "ex", ["T" * 100]),
        fastq_file(tmp_path, "ex_I2", "ex", [s1[8:]]),
    ]
    out = tmp_path / "output"
    run_demux(
        _cfg(tmp_path, inputs, ["8B", "100T", "100T", "9B"], sample_metadata, out, "native")
    )
    assert_records(
        out / "Sample0000.R1.fq.gz",
        [(b"ex_0 1:N:0:AAAAAAAA+GATTACAGA", b"A" * 100, b";" * 100)],
    )
    assert_records(
        out / "Sample0000.R2.fq.gz",
        [(b"ex_0 2:N:0:AAAAAAAA+GATTACAGA", b"T" * 100, b";" * 100)],
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_a_wierd_set_of_reads(tmp_path, engine):
    s1 = "AAAAAAAAGATTACAGA"
    sample_metadata = metadata_file(
        tmp_path, [s1, "CCCCCCCCGATTACAGA", "GGGGGGGGGATTACAGA", "GGGGGGTTGATTACAGA"]
    )
    inputs = [
        fastq_file(tmp_path, "example_1", "ex", ["AAAACCCCGGGGTTTT"]),
        fastq_file(tmp_path, "example_2", "ex", ["A" * 104]),
        fastq_file(tmp_path, "example_3", "ex", ["T" * 100 + "GAT"]),
        fastq_file(tmp_path, "example_4", "ex", ["TACAGAAAT"]),
    ]
    out = tmp_path / "output"
    run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["4B4M8S", "4B100T", "100S3B", "6B1S1M1T"],
            sample_metadata,
            out,
            engine,
        )
    )
    assert_records(
        out / "Sample0000.R1.fq.gz",
        [(b"ex_0:CCCC+A 1:N:0:AAAA+AAAA+GAT+TACAGA", b"A" * 100, b";" * 100)],
    )
    assert_records(
        out / "Sample0000.R2.fq.gz",
        [(b"ex_0:CCCC+A 2:N:0:AAAA+AAAA+GAT+TACAGA", b"T", b";")],
    )


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_multiple_templates_in_one_read(tmp_path, engine):
    s1 = "AAAAAAAAGATTACAGA"
    sample_metadata = metadata_file(
        tmp_path, [s1, "CCCCCCCCGATTACAGA", "GGGGGGGGGATTACAGA", "GGGGGGTTGATTACAGA"]
    )
    read = s1 + "A" * 20 + "C" * 20 + "T" * 20 + "C" * 20 + "G" * 20
    inputs = [fastq_file(tmp_path, "ex", "ex", [read])]
    out = tmp_path / "output"
    run_demux(
        _cfg(tmp_path, inputs, ["17B20T20S20T20S20T"], sample_metadata, out, engine)
    )
    assert_records(
        out / "Sample0000.R1.fq.gz",
        [(b"ex_0 1:N:0:AAAAAAAAGATTACAGA", b"A" * 20, b";" * 20)],
    )
    assert_records(
        out / "Sample0000.R2.fq.gz",
        [(b"ex_0 2:N:0:AAAAAAAAGATTACAGA", b"T" * 20, b";" * 20)],
    )
    assert_records(
        out / "Sample0000.R3.fq.gz",
        [(b"ex_0 3:N:0:AAAAAAAAGATTACAGA", b"G" * 20, b";" * 20)],
    )


def test_fails_if_reads_too_short(tmp_path):
    inputs = [
        fastq_file(tmp_path, "read1", "ex", ["AAAAAAA", "CCCCCCC", ""]),
        fastq_file(
            tmp_path,
            "index1",
            "ex",
            [SAMPLE1_BARCODE[0:7], SAMPLE1_BARCODE, SAMPLE1_BARCODE],
        ),
    ]
    cfg = _cfg(
        tmp_path,
        inputs,
        ["+T", "7B"],
        metadata(tmp_path),
        tmp_path / "output",
        "numpy",
        output_types=["T", "B"],
    )
    with pytest.raises(
        DemuxError,
        match=r"Read ex_2 had too few bases to demux 0 vs. 1 needed in read structure \+T.",
    ):
        run_demux(cfg)


@pytest.mark.parametrize("engine", ENGINES)
def test_skip_reads_too_short(tmp_path, engine):
    inputs = [
        fastq_file(tmp_path, "read1", "ex", ["AAAAAAA", "CCCCCCC", ""]),
        fastq_file(
            tmp_path,
            "index1",
            "ex",
            [SAMPLE1_BARCODE[0:7], SAMPLE1_BARCODE, SAMPLE1_BARCODE],
        ),
    ]
    out = tmp_path / "output"
    result = run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["+T", "7B"],
            metadata(tmp_path),
            out,
            engine,
            output_types=["T", "B"],
            skip_reasons=["too-few-bases"],
        )
    )
    assert result.skip_counts == {"TooFewBases": 1}
    metrics = {m["sample_id"]: m for m in result.metrics}
    assert sum(m["templates"] for m in result.metrics) == 2
    assert metrics["Sample0000"]["templates"] == 2
    from fqtk_tpu.io.fastq import read_fastq

    assert len(read_fastq(out / "Sample0000.R1.fq.gz")) == 2
    assert len(read_fastq(out / "Sample0000.I1.fq.gz")) == 2


def test_metrics_file_contents(tmp_path):
    sample_metadata = metadata_file(tmp_path, ["AAAA", "CCCC"])
    inputs = [
        fastq_file(
            tmp_path,
            "ex",
            "ex",
            ["AAAA" + "G" * 10, "AAAA" + "G" * 10, "CCCC" + "G" * 10, "TTTT" + "G" * 10],
        )
    ]
    out = tmp_path / "output"
    run_demux(_cfg(tmp_path, inputs, ["4B+T"], sample_metadata, out, "numpy"))
    lines = (out / "demux-metrics.txt").read_text().splitlines()
    assert lines[0] == "sample_id\tbarcode\ttemplates\tfrac_templates\tratio_to_mean\tratio_to_best"
    # Sample0000: 2 templates; Sample0001: 1; unmatched: 1; total 4; mean 1.5; best 2
    assert lines[1] == "Sample0000\tAAAA\t2\t0.5\t1.3333333333333333\t1.0"
    assert lines[2] == "Sample0001\tCCCC\t1\t0.25\t0.6666666666666666\t0.5"
    assert lines[3] == "unmatched\t.\t1\t0.25\t0.6666666666666666\t0.5"


def test_outputs_are_gzip_readable(tmp_path):
    sample_metadata = metadata_file(tmp_path, ["AAAA"])
    inputs = [fastq_file(tmp_path, "ex", "ex", ["AAAA" + "G" * 10])]
    out = tmp_path / "output"
    run_demux(_cfg(tmp_path, inputs, ["4B+T"], sample_metadata, out, "numpy"))
    with gzip.open(out / "Sample0000.R1.fq.gz", "rb") as fh:
        data = fh.read()
    assert data == b"@ex_0 1:N:0:AAAA\nGGGGGGGGGG\n+\n;;;;;;;;;;\n"


@pytest.mark.parametrize("engine", ENGINES)
def test_gzip_inputs(tmp_path, engine):
    import gzip as gz

    sample_metadata = metadata_file(tmp_path, ["AAAA"])
    raw = fastq_file(tmp_path, "ex", "ex", ["AAAA" + "G" * 10])
    gz_path = tmp_path / "ex.fastq.gz"
    with gz.open(gz_path, "wb") as fh:
        fh.write(raw.read_bytes())
    out = tmp_path / "output"
    run_demux(_cfg(tmp_path, [gz_path], ["4B+T"], sample_metadata, out, engine))
    assert_records(
        out / "Sample0000.R1.fq.gz", [(b"ex_0 1:N:0:AAAA", b"G" * 10, b";" * 10)]
    )


def test_demux_pallas_engine(tmp_path, monkeypatch):
    """The fused Triton kernel as the native engine's device matcher (the
    GPU choice, forced here and run in the Pallas interpreter), compared
    against the numpy engine byte-for-byte."""
    from fqtk_tpu.ops import pallas_matcher
    from fqtk_tpu.runtime import demux as dmod

    built = []

    def interpreted(*args, **kw):
        built.append(kw)
        return make_kernel(*args, interpret=True, **kw)

    make_kernel = pallas_matcher.make_pallas_assign_fn
    monkeypatch.setattr(dmod, "_fused_kernel_ok", lambda expected: True)
    monkeypatch.setattr(pallas_matcher, "make_pallas_assign_fn", interpreted)
    s1 = "AAAAAAAAGATTACAGA"
    sample_metadata = metadata_file(
        tmp_path, [s1, "CCCCCCCCGATTACAGA", "GGGGGGGGGATTACAGA", "GGGGGGTTGATTACAGA"]
    )
    reads = [s1 + "A" * 100, "CCCCCCCCGATTACAGA" + "G" * 100, "TTTTTTTTTTTTTTTTT" + "C" * 100,
             "NCCCCCCCGATTACAGA" + "T" * 100]
    inputs = [fastq_file(tmp_path, "ex", "ex", reads)]
    out_p = tmp_path / "out_pallas"
    out_n = tmp_path / "out_numpy"
    for out, engine, kw in [
        (out_p, "native", dict(matcher="device", devices=1)),
        (out_n, "numpy", {}),
    ]:
        res = run_demux(
            _cfg(tmp_path, inputs, ["17B100T"], sample_metadata, out, engine,
                 batch_size=64, **kw)
        )
        if engine == "native":
            assert res.matcher == "device:triton-kernel"
    assert built and built[0]["packed2"]
    for f in sorted(out_p.glob("*.fq.gz")):
        a = gzip.open(f).read()
        b = gzip.open(out_n / f.name).read()
        assert a == b, f.name
    assert (out_p / "demux-metrics.txt").read_text() == (out_n / "demux-metrics.txt").read_text()


def test_demux_empty_inputs_nan_metrics(tmp_path):
    """Zero templates: metrics divide 0/0 like the reference's f64 math
    (NaN formatted ryu-style)."""
    sample_metadata = metadata_file(tmp_path, ["AAAA"])
    empty = tmp_path / "empty.fastq"
    empty.write_text("")
    out = tmp_path / "out"
    res = run_demux(_cfg(tmp_path, [empty], ["4B+T"], sample_metadata, out, "numpy"))
    assert res.total_templates == 0
    lines = (out / "demux-metrics.txt").read_text().splitlines()
    assert lines[1] == "Sample0000\tAAAA\t0\tNaN\tNaN\tNaN"
    assert lines[2] == "unmatched\t.\t0\tNaN\tNaN\tNaN"


@pytest.mark.parametrize("engine", ENGINES)
def test_demux_single_cell_style(tmp_path, engine):
    """16C12M+T style single-cell structure: cellular barcode + UMI + template
    with a moderate whitelist; exercises C-segment outputs and UMI headers."""
    import random

    rng = random.Random(9)
    barcodes = sorted({"".join(rng.choice("ACGT") for _ in range(10)) for _ in range(200)})
    sample_metadata = metadata_file(tmp_path, barcodes)
    reads = []
    expected_assign = []
    for i in range(40):
        bc = barcodes[i % len(barcodes)]
        cell = "".join(rng.choice("ACGT") for _ in range(16))
        umi = "".join(rng.choice("ACGT") for _ in range(12))
        reads.append(cell + umi + bc + "ACGT" * 10)
        expected_assign.append(i % len(barcodes))
    inputs = [fastq_file(tmp_path, "sc", "sc", reads)]
    out = tmp_path / "out"
    run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["16C12M10B+T"],
            sample_metadata,
            out,
            engine,
            output_types=["T", "C", "M"],
            max_mismatches=1,
            min_mismatch_delta=2,
            batch_size=16,
        )
    )
    from fqtk_tpu.io.fastq import read_fastq

    total = 0
    for i, bc in enumerate(barcodes):
        recs = read_fastq(out / f"Sample{i:04d}.R1.fq.gz")
        total += len(recs)
        for r in recs:
            # UMI in name, barcode in comment
            head = r.head.decode()
            assert ":" in head.split(" ")[0]
            assert head.endswith(bc)
        assert len(read_fastq(out / f"Sample{i:04d}.C1.fq.gz")) == len(recs)
        assert len(read_fastq(out / f"Sample{i:04d}.U1.fq.gz")) == len(recs)
    assert total == 40


@pytest.mark.parametrize("engine", ENGINES)
def test_all_skip_batch_window_does_not_truncate(tmp_path, engine):
    """A batch window whose templates are ALL too-short must not end the
    stream early (regression: the parallel engine treated an all-skip window
    as EOF and silently dropped the remainder of the input)."""
    reads = []
    for i in range(20):
        # batch_size=3: records 6..11 are two full windows of short reads
        reads.append("AC" if 6 <= i < 12 else "AAAA" + "G" * 6)
    inputs = [fastq_file(tmp_path, "in", "sk", reads)]
    sample_metadata = metadata_file(tmp_path, ["AAAA"])
    out = tmp_path / "out"
    res = run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["4B+T"],
            sample_metadata,
            out,
            engine,
            skip_reasons=["too-few-bases"],
            batch_size=3,
        )
    )
    assert res.skip_counts == {"TooFewBases": 6}
    assert res.total_templates == 14
    from fqtk_tpu.io.fastq import read_fastq

    recs = read_fastq(out / "Sample0000.R1.fq.gz")
    assert len(recs) == 14
    assert recs[-1].head.startswith(b"sk_19")


@pytest.mark.parametrize("engine", ENGINES)
def test_staggered_eof_skip_uses_own_structure(tmp_path, engine):
    """When one input EOFs early, remaining records must be gated against
    their OWN read structure (reference: the min-length check runs inside
    each per-file ReadSetIterator, demux.rs:298-314) and a present-but-short
    record is counted as a skip BEFORE the out-of-sync assert fires
    (demux.rs:954-966).  Regression: the python path compacted EOF'd readers
    out of the record list, pairing survivors with the wrong structures."""
    inputs = [
        fastq_file(tmp_path, "bc", "s", ["AAAA", "AAAA"]),
        fastq_file(tmp_path, "t", "s", ["G" * 20, "G" * 20, "G" * 10, "G" * 10]),
    ]
    sample_metadata = metadata_file(tmp_path, ["AAAA"])
    out = tmp_path / "out"
    res = run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["4B", "20T"],
            sample_metadata,
            out,
            engine,
            skip_reasons=["too-few-bases"],
            batch_size=3,
        )
    )
    # templates 3-4: only file1 has records, each 10 < 20 needed by "20T"
    # (but >= the 4 needed by file0's "4B", which the bug paired them with)
    assert res.skip_counts == {"TooFewBases": 2}
    assert res.total_templates == 2


@pytest.mark.parametrize("engine", ENGINES)
def test_staggered_eof_error_cites_own_structure(tmp_path, engine):
    """Without skip-reasons, the desynced short tail must raise the
    too-few-bases error citing ITS structure, not the out-of-sync error."""
    inputs = [
        fastq_file(tmp_path, "bc", "s", ["AAAA"]),
        fastq_file(tmp_path, "t", "s", ["G" * 20, "G" * 10]),
    ]
    sample_metadata = metadata_file(tmp_path, ["AAAA"])
    with pytest.raises(DemuxError, match=r"too few bases to demux 10 vs. 20"):
        run_demux(
            _cfg(
                tmp_path,
                inputs,
                ["4B", "20T"],
                sample_metadata,
                tmp_path / "out2",
                engine,
                batch_size=3,
            )
        )


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_out_of_sync_lists_present_headers(tmp_path, engine):
    """The out-of-sync error lists the present records' headers (reference
    asserts with the records' Debug rendering, demux.rs:961-966)."""
    inputs = [
        fastq_file(tmp_path, "bc", "a", ["AAAA"]),
        fastq_file(tmp_path, "t", "b", ["G" * 20, "G" * 20]),
    ]
    sample_metadata = metadata_file(tmp_path, ["AAAA"])
    with pytest.raises(
        DemuxError, match=r"FASTQ sources out of sync at records: \[b'b_1'\]"
    ):
        run_demux(
            _cfg(
                tmp_path,
                inputs,
                ["4B", "20T"],
                sample_metadata,
                tmp_path / "out3",
                engine,
                batch_size=3,
            )
        )


def test_input_open_error_collected(tmp_path):
    """An existing-but-unopenable input surfaces as the collected 'Error
    opening input files for reading' validation error (demux.rs:843-851),
    not a later hard failure.  (A directory is used since the suite runs as
    root, where permission bits don't block open.)"""
    unopenable = tmp_path / "a_directory.fq"
    unopenable.mkdir()
    cfg = _cfg(
        tmp_path,
        [unopenable],
        ["+T"],
        metadata(tmp_path),
        tmp_path / "out",
        "numpy",
    )
    with pytest.raises(DemuxError) as e:
        run_demux(cfg)
    assert "Error opening input files for reading:" in str(e.value)
    assert "Inputs failed validation!" in str(e.value)


@pytest.mark.parametrize(
    "content,match",
    [
        ("@r1\nACGT\n+\n", "truncated FASTQ record"),
        ("r1\nACGT\n+\nIIII\n", "must start with '@'"),
        ("@r1\nACGT\nplus\nIIII\n", "must start with '\\+'"),
        ("@r1\nACGT\n+\nIII\n", "sequence and quality lengths differ"),
    ],
)
def test_native_zero_copy_parse_errors(tmp_path, content, match):
    """Malformed FASTQ surfaces the scanner's error through the pipelined
    native engine (in-place arena scan paths)."""
    bad = tmp_path / "bad.fastq"
    bad.write_text("@ok\nAAAA\n+\nIIII\n" + content)
    cfg = _cfg(
        tmp_path,
        [bad],
        ["4B"],
        metadata_file(tmp_path, ["AAAA"]),
        tmp_path / "out",
        "native",
    )
    with pytest.raises(DemuxError, match=match):
        run_demux(cfg)


def test_native_crlf_and_final_newline_free_records(tmp_path):
    """CRLF line endings and a final record without a trailing newline both
    parse identically through the zero-copy native scanner and the python
    reader."""
    crlf = tmp_path / "crlf.fastq"
    crlf.write_bytes(
        b"@a 1:N:0:0\r\nAAAAGGGG\r\n+\r\nIIIIIIII\r\n"
        b"@b 1:N:0:0\r\nAAAATTTT\r\n+\r\nIIIIIIII"  # no trailing newline
    )
    meta = metadata_file(tmp_path, ["AAAA"])
    import gzip

    outs = {}
    for engine in ("native", "numpy"):
        out = tmp_path / f"out_{engine}"
        res = run_demux(
            _cfg(tmp_path, [crlf], ["4B+T"], meta, out, engine)
        )
        assert res.total_templates == 2
        outs[engine] = gzip.decompress((out / "Sample0000.R1.fq.gz").read_bytes())
    assert outs["native"] == outs["numpy"]
    assert b"@a 1:N:0:AAAA\nGGGG\n" in outs["native"]


def test_native_record_longer_than_fill_chunk(tmp_path):
    """A record whose line exceeds the 1MB inflate chunk forces repeated
    arena growth mid-record (zero-copy scanner resize path)."""
    big = "G" * (3 << 20)
    p = fastq_file(tmp_path, "big", "bg", ["AAAA" + big, "AAAA" + "T" * 8])
    meta = metadata_file(tmp_path, ["AAAA"])
    out = tmp_path / "out"
    res = run_demux(
        _cfg(tmp_path, [p], ["4B+T"], meta, out, "native", batch_size=4)
    )
    assert res.total_templates == 2
    from fqtk_tpu.io.fastq import read_fastq

    recs = read_fastq(out / "Sample0000.R1.fq.gz")
    assert len(recs) == 2
    assert recs[0].seq == big.encode()
    # the record exceeds one BGZF block (65,280B input cap), so this also
    # drives write_template's huge-record fallback and the writer's
    # multi-block split; outputs must still be byte-identical to numpy
    out_np = tmp_path / "out_np"
    run_demux(_cfg(tmp_path, [p], ["4B+T"], meta, out_np, "numpy", batch_size=4))
    for name in ("Sample0000.R1.fq.gz", "unmatched.R1.fq.gz"):
        assert gzip.decompress((out / name).read_bytes()) == gzip.decompress(
            (out_np / name).read_bytes()
        )


def test_quality_lines_starting_with_at_or_plus(tmp_path):
    """Quality strings may begin with '@' or '+' (legal FASTQ); parsers
    that sniff record starts by '@' corrupt these.  Both engines must
    agree byte-for-byte."""
    fq = tmp_path / "in.fq"
    fq.write_text(
        "@r0\nAAAACGTA\n+\n@@@@++++\n@r1\nCCCCGTAC\n+\n+@+@+@+@\n"
    )
    meta = metadata_file(tmp_path, ["AAAA", "CCCC"])
    outs = {}
    for engine in ("native", "numpy"):
        out = tmp_path / f"o_{engine}"
        run_demux(_cfg(tmp_path, [fq], ["4B+T"], meta, out, engine))
        outs[engine] = out
    for f in ("Sample0000.R1.fq.gz", "Sample0001.R1.fq.gz"):
        a = gzip.decompress((outs["native"] / f).read_bytes())
        b = gzip.decompress((outs["numpy"] / f).read_bytes())
        assert a == b and len(a) > 0


def test_native_empty_gzip_input(tmp_path):
    """Zero-record inputs produce empty outputs and NaN-style metrics
    through the pipelined engine (EOF window on the first acquire)."""
    import gzip

    p = tmp_path / "empty.fq.gz"
    with gzip.open(p, "wb"):
        pass
    meta = metadata_file(tmp_path, ["AAAA"])
    out = tmp_path / "out"
    res = run_demux(_cfg(tmp_path, [p], ["4B+T"], meta, out, "native"))
    assert res.total_templates == 0
    assert "NaN" in (out / "demux-metrics.txt").read_text()


def test_read_only_output_dir_fails(tmp_path):
    """Reference checks the output dir's permission BITS (demux.rs:824-827),
    so the error fires even for root (mirrors
    test_read_only_output_dir_fails)."""
    inputs = [fastq_file(tmp_path, "r1", "ex", ["GATTACA"])]
    out = tmp_path / "ro_out"
    out.mkdir()
    out.chmod(0o555)
    try:
        with pytest.raises(
            DemuxError, match=r'Ouput directory .* cannot be read-only'
        ):
            run_demux(
                _cfg(tmp_path, inputs, ["+T"], metadata(tmp_path), out, "numpy")
            )
    finally:
        out.chmod(0o755)


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_out_of_sync_header_rendering_matches_bytes_repr(tmp_path, engine):
    """Headers with quotes render identically in both engines' out-of-sync
    error (CPython bytes-repr rules, incl. the quote-flip case)."""
    (tmp_path / "bc.fastq").write_text("@a'q\nAAAA\n+\nIIII\n")
    # the second template desyncs: only t.fastq has a record, and ITS header
    # carries a single quote to force the repr quote-flip
    (tmp_path / "t.fastq").write_text(
        "@b1\nGGGGGGGGGGGGGGGGGGGG\n+\nIIIIIIIIIIIIIIIIIIII\n"
        "@b'x y\nGGGGGGGGGGGGGGGGGGGG\n+\nIIIIIIIIIIIIIIIIIIII\n"
    )
    meta = metadata_file(tmp_path, ["AAAA"])
    with pytest.raises(DemuxError) as e:
        run_demux(
            _cfg(
                tmp_path,
                [tmp_path / "bc.fastq", tmp_path / "t.fastq"],
                ["4B", "20T"],
                meta,
                tmp_path / f"out_{engine}",
                engine,
                batch_size=3,
            )
        )
    assert 'b"b\'x y"' in str(e.value) or "b\"b'x y\"" in str(e.value)


def test_device_failure_mid_run_tears_down_cleanly(tmp_path, monkeypatch):
    """If the device matcher raises mid-stream (e.g. a device runtime error),
    the exception must propagate promptly and the engine teardown must join
    its parse/route threads without deadlock."""
    from fqtk_tpu.runtime import demux as dmod

    calls = {"n": 0}

    def flaky_factory(cfg, expected, barcodes=None):
        import numpy as np

        def assign(obs):
            calls["n"] += 1
            if calls["n"] >= 2:
                raise RuntimeError("simulated device backend failure")
            return np.zeros(obs.shape[0], dtype=np.int32)

        return assign, "nib4", False

    monkeypatch.setattr(dmod, "_build_device_assign_fn", flaky_factory)
    dmod._ASSIGN_FN_CACHE.clear()

    reads = ["AAAA" + "G" * 10] * 40
    inputs = [fastq_file(tmp_path, "in", "df", reads)]
    cfg = _cfg(
        tmp_path,
        inputs,
        ["4B+T"],
        metadata_file(tmp_path, ["AAAA"]),
        tmp_path / "out",
        "native",
        batch_size=8,
    )
    with pytest.raises(RuntimeError, match="simulated device backend failure"):
        run_demux(cfg)
    # the engine must be fully torn down: a fresh run on the same inputs
    # succeeds (no leaked global state, no stuck threads)
    dmod._ASSIGN_FN_CACHE.clear()
    monkeypatch.undo()
    res = run_demux(
        _cfg(
            tmp_path,
            inputs,
            ["4B+T"],
            metadata_file(tmp_path, ["AAAA"]),
            tmp_path / "out2",
            "native",
            batch_size=8,
        )
    )
    assert res.total_templates == 40


@pytest.mark.parametrize("engine", ["numpy", "native"])
@pytest.mark.parametrize("compression", ["plain", "gzip", "bgzf"])
def test_fifo_inputs_stream_without_seeking(tmp_path, engine, compression):
    """Non-seekable inputs (named pipes / process substitution) must stream:
    the readers sniff the gzip/BGZF magic without seeking back (the
    reference's buffered reader contract), and validation must not
    open-close a pipe (that would kill the writer before the real open)."""
    import os
    import threading

    from fqtk_tpu.io.fastq import BgzfWriter

    barcodes = ["AAAAAAAAGATTACAGA", "CCCCCCCCGATTACAGA"]
    sample_metadata = metadata_file(tmp_path, barcodes)
    n = 40
    bases = [barcodes[i % 2] + "ACGT" * 10 for i in range(n)]

    # file-based reference run (same engine) for byte comparison
    ref_in = fastq_file(tmp_path, "ref", "ex", bases)
    out_ref = tmp_path / "out_ref"
    run_demux(
        _cfg(tmp_path, [ref_in], ["17B+T"], sample_metadata, out_ref, engine)
    )

    payload = ref_in.read_bytes()
    if compression == "gzip":
        payload = gzip.compress(payload)
    elif compression == "bgzf":
        bpath = tmp_path / "ref.bgzf"
        w = BgzfWriter(bpath, compression_level=5)
        w.write(payload)
        w.close()
        payload = bpath.read_bytes()

    fifo = tmp_path / "in.fifo"
    os.mkfifo(fifo)

    def feed():
        with open(fifo, "wb") as fh:
            fh.write(payload)

    t = threading.Thread(target=feed)
    t.start()
    try:
        out_fifo = tmp_path / "out_fifo"
        run_demux(
            _cfg(tmp_path, [fifo], ["17B+T"], sample_metadata, out_fifo, engine)
        )
    finally:
        t.join(timeout=30)
    assert not t.is_alive()

    for p in sorted(out_ref.glob("*.fq.gz")):
        a = gzip.decompress(p.read_bytes())
        b = gzip.decompress((out_fifo / p.name).read_bytes())
        assert a == b, f"{p.name} differs between file and FIFO input"
    assert (out_ref / "demux-metrics.txt").read_text() == (
        out_fifo / "demux-metrics.txt"
    ).read_text()


def test_native_demux_fails_cleanly_on_disk_full(tmp_path):
    """ENOSPC mid-run must fail the run with the operator-facing write
    error, never report success over truncated outputs.  Uses a tiny tmpfs
    as the output directory (root + mount required; skipped elsewhere)."""
    import os
    import subprocess

    from fqtk_tpu.io import native as native_io

    if not native_io.available():
        pytest.skip("native library unavailable")
    if os.geteuid() != 0:
        pytest.skip("requires root to mount a tmpfs")
    out = tmp_path / "out_full"
    out.mkdir()
    r = subprocess.run(
        ["mount", "-t", "tmpfs", "-o", "size=64k", "tmpfs", str(out)],
        capture_output=True,
    )
    if r.returncode != 0:
        pytest.skip(f"cannot mount tmpfs: {r.stderr.decode().strip()}")
    try:
        import numpy as np

        rng = np.random.default_rng(5)
        barcodes = ["AAAAAAAAGATTACAGA", "CCCCCCCCGATTACAGA"]
        sample_metadata = metadata_file(tmp_path, barcodes)
        letters = np.frombuffer(b"ACGT", dtype=np.uint8)
        bases = [
            barcodes[i % 2] + bytes(letters[rng.integers(0, 4, 100)]).decode()
            for i in range(40_000)
        ]
        src = fastq_file(tmp_path, "big", "ex", bases)
        with pytest.raises(DemuxError, match="Error writing output file"):
            run_demux(
                _cfg(
                    tmp_path,
                    [src],
                    ["17B+T"],
                    sample_metadata,
                    out,
                    "native",
                    batch_size=4096,
                )
            )
    finally:
        subprocess.run(["umount", "-l", str(out)], capture_output=True)


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_truncated_gzip_member_fails_not_truncates(tmp_path, engine):
    """A gzip input truncated mid-member whose decompressed prefix ends at
    a clean record boundary must FAIL (the silent-data-loss class): the
    native scanner tracks mid-member state at EOF, the Python reader gets
    EOFError from gzip."""
    import zlib

    rec = b"@r0 1:N:0:0\nAAAAAAAAGATTACAGAACGT\n+\n" + b"I" * 21 + b"\n"
    co = zlib.compressobj(5, zlib.DEFLATED, 31)
    part1 = co.compress(rec * 32) + co.flush(zlib.Z_FULL_FLUSH)
    co.compress(rec * 32) + co.flush(zlib.Z_FINISH)  # never written
    trunc = tmp_path / "trunc.fq.gz"
    trunc.write_bytes(part1)
    meta = metadata_file(tmp_path, ["AAAAAAAAGATTACAGA"])
    cfg = _cfg(tmp_path, [trunc], ["17B+T"], meta, tmp_path / "out", engine,
               batch_size=16)
    with pytest.raises(Exception, match="read/decompress error|end-of-stream"):
        run_demux(cfg)


@pytest.mark.parametrize("engine", ["numpy", "native"])
def test_bgzf_with_extra_fextra_subfield(tmp_path, engine):
    """Spec-valid BGZF whose FEXTRA carries additional subfields besides BC
    (the SAM spec requires BC to be present, not alone) must read correctly
    — the native block readers scan the subfields for BC."""
    import struct
    import zlib

    def block(payload: bytes, extra_first: bool) -> bytes:
        co = zlib.compressobj(5, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        xx = b"XX" + struct.pack("<H", 2) + b"ab" if extra_first else b""
        xlen = len(xx) + 6
        bsize = 12 + xlen + len(comp) + 8
        hdr = (
            b"\x1f\x8b\x08\x04" + b"\x00" * 4 + b"\x00\xff"
            + struct.pack("<H", xlen) + xx
            + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1)
        )
        return (hdr + comp + struct.pack("<I", zlib.crc32(payload))
                + struct.pack("<I", len(payload)))

    eof_blk = bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"
    )
    rec = b"@r0 1:N:0:0\nAAAAAAAAGATTACAGAACGT\n+\n" + b"I" * 21 + b"\n"
    # first member standard (the sniffer keys on it), second with an extra
    # subfield before BC — a mixed-layout but fully valid BGZF stream
    p = tmp_path / "multi_subfield.fq.gz"
    p.write_bytes(block(rec * 10, False) + block(rec * 10, True) + eof_blk)
    meta = metadata_file(tmp_path, ["AAAAAAAAGATTACAGA"])
    cfg = _cfg(tmp_path, [p], ["17B+T"], meta, tmp_path / f"out_{engine}",
               engine, batch_size=8)
    assert run_demux(cfg).total_templates == 20


def test_jax_engine_variable_length_barcode_override(tmp_path):
    """The jax engine's assignment array must be writable: reads whose
    variable-length barcode differs from the whitelist length are forced
    to unmatched via an element override (np.asarray of a jax.Array is
    read-only; a crash here was a real regression class)."""
    barcodes = ["GATTACAT"]
    meta = metadata_file(tmp_path, barcodes)
    # 4T+B: an 11bp read yields a 7bp barcode (too short) that is all Ns,
    # so the no-call gate forces unmatched instead of raising
    recs = ["ACGT" + "GATTACAT", "ACGT" + "NNNNNNN"]
    src = fastq_file(tmp_path, "vb", "ex", recs)
    cfg = _cfg(
        tmp_path, [src], ["4T+B"], meta, tmp_path / "out", "jax", batch_size=4
    )
    res = run_demux(cfg)
    assert res.total_templates == 2
    import gzip as _gzip

    matched = _gzip.decompress((tmp_path / "out" / "Sample0000.R1.fq.gz").read_bytes())
    unmatched = _gzip.decompress((tmp_path / "out" / "unmatched.R1.fq.gz").read_bytes())
    assert matched.count(b"@") == 1 and unmatched.count(b"@") == 1


def test_device_overlap_byte_identical(tmp_path, monkeypatch):
    """The double-buffered device dispatch (one window's device call in
    flight while the previous fetches/routes) must be byte-identical to
    the serial acquire->assign->submit loop, across multiple windows
    including exceptional (non-ACGT) rows."""
    import gzip

    from fqtk_tpu.io import native as native_io

    if not native_io.available():
        pytest.skip("native library unavailable")
    monkeypatch.setenv("FQTK_HOST_MATCHER_MAX_K", "0")  # force device branch
    monkeypatch.setenv("FQTK_DEVICE_DEDUP", "0")  # full windows to device
    barcodes = [
        "".join("ACGT"[(7 * i + 3 * j) % 4] for j in range(12))
        for i in range(13)
    ]
    barcodes = sorted(set(barcodes))
    reads = []
    for i in range(530):  # several 64-row windows
        bc = barcodes[i % len(barcodes)]
        if i % 17 == 0:
            bc = bc[:5] + "N" + bc[6:]  # exceptional row (numpy-spec path)
        reads.append(bc + "ACGTAC")
    meta = metadata_file(tmp_path, barcodes)
    fq = fastq_file(tmp_path, "r1", "q", reads)
    outs = {}
    for arm in ("1", "0"):
        monkeypatch.setenv("FQTK_DEVICE_OVERLAP", arm)
        out = tmp_path / f"out_{arm}"
        run_demux(
            _cfg(
                tmp_path, [fq], ["12B+T"], meta, out, "native",
                batch_size=64,
            )
        )
        blob = {}
        for p in sorted(out.glob("*.fq.gz")):
            blob[p.name] = gzip.open(p).read()
        blob["metrics"] = (out / "demux-metrics.txt").read_bytes()
        outs[arm] = blob
    assert outs["1"] == outs["0"]
    assert any(len(v) for v in outs["1"].values())
