"""Package boundary of the PyTorch port: it imports neither JAX nor the JAX
package, it never falls back to the CPU when CUDA is asked for, and its
kernel build is keyed on the sources and fails loudly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mcmcpp_tpu_torch
from mcmcpp_tpu_torch import _build

torch.set_num_threads(1)

PKG = Path(mcmcpp_tpu_torch.__file__).parent
REPO = PKG.parent


def test_import_pulls_in_no_jax_or_triton():
    code = ("import sys, mcmcpp_tpu_torch; "
            "bad = [m for m in ('jax', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    banned = ("jax", "jaxlib", "mcmcpp_tpu", "triton", "ml_dtypes")
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 40
    for new in ("chain_disk.py", "convergence.py", "export.py",
                "compat/emcee.py", "io/checkpoint.py", "io/engines.py",
                "io/outputs.py", "io/writer.py", "utils/metrics.py",
                "analysis/ess.py", "analysis/covariance.py",
                "analysis/histograms.py", "analysis/percentiles.py",
                "analysis/streaming.py", "analysis/diagnostics.py",
                "examples/skewed_gaussian.py", "examples/actime.py",
                "examples/inner_benchmark.py"):
        assert PKG / new in files, new
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"


def test_every_module_imports_without_optional_packages():
    """Importing every module of the port, the examples too, loads none of
    jax, ml_dtypes, triton, h5py, arviz (nor the JAX package)."""
    code = (
        "import importlib, pkgutil, sys, mcmcpp_tpu_torch as m\n"
        "names = [i.name for i in pkgutil.walk_packages(m.__path__, "
        "m.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 45, len(names)\n"
        "bad = [b for b in ('jax', 'ml_dtypes', 'triton', 'h5py', 'arviz', "
        "'mcmcpp_tpu') if b in sys.modules]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_requested_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    from mcmcpp_tpu_torch import EnsembleSampler, skewed_gaussian

    with pytest.raises(RuntimeError, match="is_available"):
        EnsembleSampler(skewed_gaussian(device="cpu"), 8, 2, batched=True)


def test_library_name_tracks_sources(tmp_path, monkeypatch):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first
    assert first.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == REPO / "build" / "kernels"


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not any((tmp_path / "kernels").glob("*.so"))


def test_build_dir_is_ignored_by_git():
    ignore = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignore
    assert os.path.isdir(PKG / "csrc")
