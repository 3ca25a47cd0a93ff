"""Shared helpers for end-to-end tests: synthesize FASTQs like the reference's
test fixtures (``/root/reference/src/bin/commands/demux.rs:1018-1093``)."""

from pathlib import Path
from typing import List, Sequence, Tuple

from fqtk_tpu.io.fastq import read_fastq

SAMPLE1_BARCODE = "GATTGGG"


def fq_lines_from_bases(prefix: str, records_bases: Sequence[str]) -> List[str]:
    lines = []
    for i, bases in enumerate(records_bases):
        lines += [f"@{prefix}_{i}", bases, "+", ";" * len(bases)]
    return lines


def fastq_file(
    tmpdir: Path, filename_prefix: str, read_prefix: str, records_bases: Sequence[str]
) -> Path:
    path = Path(tmpdir) / f"{filename_prefix}.fastq"
    path.write_text("\n".join(fq_lines_from_bases(read_prefix, records_bases)) + "\n")
    return path


def metadata_file(tmpdir: Path, barcodes: Sequence[str]) -> Path:
    path = Path(tmpdir) / "metadata.tsv"
    lines = ["sample_id\tbarcode"]
    for i, b in enumerate(barcodes):
        lines.append(f"Sample{i:04d}\t{b}")
    path.write_text("\n".join(lines) + "\n")
    return path


def metadata(tmpdir: Path) -> Path:
    return metadata_file(tmpdir, [SAMPLE1_BARCODE])


def assert_records(path: Path, expected: Sequence[Tuple[bytes, bytes, bytes]]) -> None:
    recs = read_fastq(path)
    assert len(recs) == len(expected), f"{path}: {len(recs)} != {len(expected)}"
    for actual, (head, seq, qual) in zip(recs, expected):
        assert actual.head == head, f"{path}: {actual.head!r} != {head!r}"
        assert actual.seq == seq, f"{path}: {actual.seq!r} != {seq!r}"
        assert actual.qual == qual, f"{path}: {actual.qual!r} != {qual!r}"


def pack_bit2(obs):
    """[B, L] pure-ACGT ASCII -> [B, ceil(L/4)] 2-bit codes, lowest bit pair
    first (the native engine's bit2 transfer layout)."""
    import numpy as np

    code = np.zeros(256, dtype=np.uint8)
    for c, ch in zip((0, 1, 2, 3), b"ACGT"):
        code[ch] = c
    b, length = obs.shape
    padded = np.zeros((b, -(-length // 4) * 4), dtype=np.uint8)
    padded[:, :length] = code[obs]
    return (
        padded[:, 0::4] | (padded[:, 1::4] << 2) | (padded[:, 2::4] << 4)
        | (padded[:, 3::4] << 6)
    ).astype(np.uint8)


def pack_nib4(obs):
    """[B, L] ASCII -> [B, ceil(L/2)] 4-bit IUPAC masks, low nibble first
    (the native engine's nib4 transfer layout; odd L pads with 'A')."""
    import numpy as np

    from fqtk_tpu.core.encoding import ENCODE_LUT

    masks = ENCODE_LUT[obs]
    b, length = masks.shape
    if length % 2:
        masks = np.concatenate([masks, np.ones((b, 1), dtype=np.uint8)], axis=1)
    return (masks[:, 0::2] | (masks[:, 1::2] << 4)).astype(np.uint8)
