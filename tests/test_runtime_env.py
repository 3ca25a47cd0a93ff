"""Where the program keeps its compile cache, how the native engine fails,
the benchmark's peak table, and chip_smoke.py's refusals off the card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run_py(code, env_updates, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_updates)
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=cwd, timeout=120,
    )


@pytest.mark.parametrize("preset", [None, "/tmp/fqtk-cache-from-env"])
def test_compile_cache_dir_before_jax_import(preset):
    """Unset: the fixed in-checkout .jax_cache/; set: used as it is."""
    code = (
        "import os, sys\n"
        "from fqtk_tpu.utils.jaxcache import enable_compilation_cache\n"
        "assert 'jax' not in sys.modules\n"
        "got = enable_compilation_cache()\n"
        "print(got, os.environ['JAX_COMPILATION_CACHE_DIR'])\n"
    )
    r = _run_py(code, {} if preset is None else {"JAX_COMPILATION_CACHE_DIR": preset})
    assert r.returncode == 0, r.stderr
    want = str(REPO / ".jax_cache") if preset is None else preset
    assert r.stdout.split() == [want, want]


def test_compile_cache_dir_with_jax_imported(monkeypatch):
    """jax already imported and no env: the checkout's cache goes into
    jax's config; with the env set, jax's config is left alone."""
    import jax

    from fqtk_tpu.utils import jaxcache

    saved = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert jaxcache.enable_compilation_cache() == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", saved)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert jaxcache.enable_compilation_cache() == "/elsewhere"
        assert jax.config.jax_compilation_cache_dir == saved
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failing `make -C native` is an error carrying the compiler output,
    never a quiet switch to another engine."""
    from fqtk_tpu.io import native

    (tmp_path / "Makefile").write_text("all:\n\t@echo 'fqtk_io.cpp:1: error: boom' >&2; false\n")
    monkeypatch.delenv("FQTK_NATIVE_LIB", raising=False)
    monkeypatch.setattr(native, "_LIB_PATH", tmp_path / "libfqtk_io.so")
    with pytest.raises(native.NativeLibraryError, match="boom"):
        native._load()


def test_native_load_failure_raises(monkeypatch, tmp_path):
    from fqtk_tpu.io import native

    bad = tmp_path / "libfqtk_io.so"
    bad.write_bytes(b"not a shared object")
    monkeypatch.setenv("FQTK_NATIVE_LIB", str(bad))
    with pytest.raises(native.NativeLibraryError, match="loading"):
        native._load()


def test_demux_auto_engine_fails_when_native_is_missing(monkeypatch, tmp_path):
    """engine=auto means the native engine: a build failure surfaces as a
    DemuxError, not a run on the Python engine."""
    from fqtk_tpu.io import native
    from fqtk_tpu.runtime import demux

    def broken():
        raise native.NativeLibraryError("building native/libfqtk_io.so failed")

    monkeypatch.setattr(native, "get_lib", broken)
    fq = tmp_path / "in.fastq"
    fq.write_text("@r\nACGT\n+\nIIII\n")
    meta = tmp_path / "meta.tsv"
    meta.write_text("sample_id\tbarcode\nS\tACGT\n")
    cfg = demux.DemuxConfig(
        inputs=[fq], read_structures=["4B"], sample_metadata=meta,
        output=tmp_path / "out",
    )
    with pytest.raises(demux.DemuxError, match="build"):
        demux.run_demux(cfg)
    assert not (tmp_path / "out" / "demux-metrics.txt").exists()


def test_peak_table_is_keyed_by_device_kind():
    """Published dense H100 peaks; an unknown kind has no peak (never an
    assumed one)."""
    sys.path.insert(0, str(REPO))
    import bench

    assert bench._peak_ops("int8", "NVIDIA H100 80GB HBM3") == (
        1.979e15, "NVIDIA H100 80GB HBM3",
    )
    assert bench._peak_ops("bf16", "NVIDIA H100 80GB HBM3")[0] == 9.89e14
    assert bench._peak_ops("int8", "cpu") == (None, "cpu")
    assert bench._peak_ops("int8", "Some Future GPU") == (None, "Some Future GPU")
    assert bench.matcher_ops_per_read(8192, 16) == 2.0 * 8192 * 4 * 16


def test_chip_smoke_refuses_without_a_gpu():
    r = _run_py(
        "import runpy, sys; sys.argv = ['chip_smoke.py']; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')",
        {"JAX_PLATFORMS": "cpu"},
    )
    assert r.returncode == 2, (r.returncode, r.stderr[-500:])
    assert "not a GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        env=env, cwd=tmp_path, timeout=120,
    )
    assert r.returncode == 2, (r.returncode, r.stderr[-500:])
    assert "not next to chip_smoke.py" in r.stderr
    assert r.stdout.strip() == ""
