"""fqtk-tpu: a FASTQ toolkit with a device-batched barcode matcher.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``fulcrumgenomics/fqtk`` (sample demultiplexing and subsampling of FASTQ
files): batched IUPAC one-hot barcode matching as an integer matrix product
on the accelerator, data-parallel streaming over device meshes, and native
host I/O.

Layers (see SURVEY.md §1):

- ``fqtk_tpu.core``     — pure host logic: encoding tables, read structures,
                          sample metadata, header rewriting.
- ``fqtk_tpu.ops``      — device compute: batched mismatch counting + top-2
                          assignment (XLA scan and a fused Triton kernel).
- ``fqtk_tpu.parallel`` — mesh/sharding: data-parallel reads, K-sharded
                          whitelists, collective metric merges.
- ``fqtk_tpu.io``       — FASTQ parsing and BGZF writing (Python fallback +
                          native C++ engine).
- ``fqtk_tpu.runtime``  — the demux/subsample pipeline orchestrators.
- ``fqtk_tpu.cli``      — flag-compatible command line.
"""

__version__ = "0.1.0"

#: reference-parity library surface (``fqtk_lib``'s public items, SURVEY §2a
#: #5-#8), importable from the top level like ``use fqtk_lib::...``.  Lazy so
#: that ``import fqtk_tpu`` stays free of numpy/jax import cost.
_LAZY = {
    "encode": "fqtk_tpu.core.encoding",
    "decode": "fqtk_tpu.core.encoding",
    "byte_is_nocall": "fqtk_tpu.core.encoding",
    "is_valid_iupac": "fqtk_tpu.core.encoding",
    "BitEnc": "fqtk_tpu.core.bitenc",
    "BarcodeMatch": "fqtk_tpu.core.barcode_matcher",
    "BarcodeMatcher": "fqtk_tpu.core.barcode_matcher",
    "Sample": "fqtk_tpu.core.samples",
    "SampleGroup": "fqtk_tpu.core.samples",
    "ReadStructure": "fqtk_tpu.core.read_structure",
    "SegmentType": "fqtk_tpu.core.read_structure",
}

__all__ = sorted(_LAZY) + ["__version__"]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return __all__
