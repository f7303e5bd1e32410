"""Package boundary of the PyTorch port: it imports neither JAX nor the JAX
package, it never falls back to the CPU when CUDA is asked for, and its
kernel build is keyed on the sources and fails loudly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
    banned = ("jax", "jaxlib", "mcmcpp_tpu", "triton", "ml_dtypes", "optax")
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 40
    for new in ("chain_disk.py", "convergence.py", "export.py",
                "compat/emcee.py", "io/checkpoint.py", "io/engines.py",
                "io/outputs.py", "io/writer.py", "utils/metrics.py",
                "analysis/ess.py", "analysis/covariance.py",
                "analysis/histograms.py", "analysis/percentiles.py",
                "analysis/streaming.py", "analysis/diagnostics.py",
                "examples/skewed_gaussian.py", "examples/actime.py",
                "examples/inner_benchmark.py", "gradient/__init__.py",
                "gradient/metric.py", "gradient/hmc.py", "gradient/mala.py",
                "gradient/barker.py", "gradient/nuts.py", "gradient/chees.py",
                "gradient/meads.py", "gradient/mclmc.py",
                "gradient/sgmcmc.py", "tempering.py", "pcn.py",
                "elliptical.py", "gibbs.py", "optim.py", "neutra.py",
                "vi.py", "smc.py", "nested.py", "svgd.py", "pathfinder.py",
                "map_laplace.py", *SLICE8_MODULES):
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


# the DSL, the GP models and the rest of the analysis layer
SLICE8_MODULES = ("ops/special.py", "dsl.py", "models/gp.py",
                  "models/hsgp.py", "analysis/importance.py",
                  "analysis/power_scaling.py", "analysis/model_compare.py",
                  "analysis/rstar.py", "analysis/scores.py",
                  "analysis/ksd.py", "analysis/bridge.py",
                  "analysis/global_stats.py", "analysis/sbc.py",
                  "examples/hierarchical.py")


def test_dsl_gp_and_analysis_import_no_jax_sklearn_or_triton():
    """The slice's modules import no JAX, no sklearn (rstar imports it when
    it runs) and no triton."""
    mods = [m[:-3].replace("/", ".") for m in SLICE8_MODULES]
    code = ("import sys\n"
            + "".join(f"import mcmcpp_tpu_torch.{m}\n" for m in mods)
            + "bad = [m for m in ('jax', 'sklearn', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the JAX package's exports of these modules (mcmcpp_tpu/__init__.py,
# mcmcpp_tpu/analysis/__init__.py, mcmcpp_tpu/models/__init__.py)
SLICE8_NAMES = ("Model", "dsl", "models")
SLICE8_ANALYSIS = ("ksd", "ksd_curve", "crps_ensemble", "energy_score",
                   "ElpdResult", "compare", "loo", "pseudo_bma_weights",
                   "stacked_predictive_resample", "stacking_weights", "waic",
                   "BridgeResult", "bridge_log_evidence", "rstar",
                   "PowerScaleResult", "SensitivityResult", "powerscale",
                   "powerscale_sensitivity", "global_autocorr_time",
                   "global_batch_means_ess", "global_correlation_matrix",
                   "global_covariance_matrix", "global_effective_sample_size",
                   "global_ess_bulk", "global_ess_tail", "global_mcse_mean",
                   "global_multivariate_ess", "global_rank_normalized_rhat",
                   "global_split_rhat", "global_summary", "sbc_ecdf_band",
                   "sbc_model", "sbc_ranks", "sbc_summary", "sbc_uniformity")


def test_exports_the_jax_packages_dsl_gp_and_analysis_names():
    import mcmcpp_tpu_torch as mt
    from mcmcpp_tpu_torch import analysis, models

    for name in SLICE8_NAMES:
        assert name in mt.__all__ and getattr(mt, name) is not None
    # JAX's analysis/__init__.py imports rstar and the power-scaling names
    # without listing them in __all__; the port does the same
    unlisted = {"rstar", "PowerScaleResult", "SensitivityResult",
                "powerscale", "powerscale_sensitivity"}
    assert set(SLICE8_ANALYSIS) - unlisted <= set(analysis.__all__)
    assert not unlisted & set(analysis.__all__)
    for name in SLICE8_ANALYSIS:
        assert getattr(analysis, name) is not None
    assert {"gp", "hsgp"} <= set(models.__all__)


def test_gradient_import_pulls_in_no_jax_or_triton():
    code = ("import sys, mcmcpp_tpu_torch.gradient as g; "
            "assert len(g.__all__) == 18; "
            "bad = [m for m in ('jax', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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


@pytest.mark.parametrize("name", [
    "HMCSampler", "NUTSSampler", "MALASampler", "BarkerSampler",
    "CheesHMCSampler", "MEADSSampler", "MCLMCSampler", "MAMSSampler",
    "SGLDSampler", "SGHMCSampler"])
def test_gradient_engines_on_cuda_without_gpu_raise(name):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    import mcmcpp_tpu_torch as mt

    logp = mt.equicorrelated_gaussian(4, device="cpu")
    args = ((lambda t: -0.5 * (t * t).sum(-1), lambda t, b: t.sum(-1),
             torch.zeros(8, 1), 16, 4, 4) if name.startswith("SG")
            else (logp, 16, 4))
    with pytest.raises(RuntimeError, match="is_available"):
        getattr(mt, name)(*args)


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


def test_population_import_pulls_in_no_jax_or_triton():
    code = ("import sys; import mcmcpp_tpu_torch.tempering, "
            "mcmcpp_tpu_torch.pcn, mcmcpp_tpu_torch.elliptical, "
            "mcmcpp_tpu_torch.gibbs; "
            "bad = [m for m in ('jax', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name", [
    "ParallelTemperingSampler", "PCNSampler", "EllipticalSliceSampler",
    "BlockedGibbsSampler"])
def test_population_engines_on_cuda_without_gpu_raise(name):
    """The population engines run on "cuda" unless asked for the CPU, and
    never fall back to it."""
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    import mcmcpp_tpu_torch as mt

    def logp(t):
        return -0.5 * torch.sum(t * t)

    args = {
        "ParallelTemperingSampler": (logp, 8, 2),
        "PCNSampler": (logp, np.zeros(2)),
        "EllipticalSliceSampler": (logp, np.zeros(2)),
        "BlockedGibbsSampler": ([("x", 2, mt.RWMKernel(
            lambda x, o: logp(x), 0.5))], 4),
    }[name]
    kw = {} if name in ("ParallelTemperingSampler",
                        "BlockedGibbsSampler") else {"prior_scale":
                                                     np.ones(2)}
    with pytest.raises(RuntimeError, match="is_available"):
        getattr(mt, name)(*args, **kw)


EVIDENCE_MODULES = ("optim", "neutra", "vi", "smc", "nested", "svgd",
                    "pathfinder", "map_laplace")


def test_evidence_import_pulls_in_no_jax_optax_or_triton():
    code = ("import sys\n"
            + "".join(f"import mcmcpp_tpu_torch.{m}\n"
                      for m in EVIDENCE_MODULES)
            + "bad = [m for m in ('jax', 'optax', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the JAX package's exports of the evidence and variational engines
# (mcmcpp_tpu/__init__.py)
EVIDENCE_NAMES = ("SMCSampler", "NestedSampler", "ADVI", "SVGD", "find_map",
                  "laplace", "laplace_sample", "multi_pathfinder",
                  "pathfinder", "NeuTra", "RealNVP", "IAF", "SplineCoupling",
                  "nested_to_inference_dict")


@pytest.mark.parametrize("name", EVIDENCE_NAMES)
def test_exports_the_jax_packages_evidence_names(name):
    import mcmcpp_tpu_torch as mt

    assert name in mt.__all__ and getattr(mt, name) is not None


@pytest.mark.parametrize("name", [
    "SMCSampler", "NestedSampler", "NeuTra", "ADVI", "SVGD", "pathfinder",
    "multi_pathfinder", "find_map"])
def test_evidence_engines_on_cuda_without_gpu_raise(name):
    """The evidence and variational engines run on "cuda" unless asked for
    the CPU, and never fall back to it."""
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    import mcmcpp_tpu_torch as mt

    def logp(t):
        return -0.5 * torch.sum(t * t)

    args = {
        "SMCSampler": (logp, logp, None, 8, 2),
        "NestedSampler": (logp, logp, None, 2),
        "NeuTra": (logp, 2),
        "ADVI": (logp, 2),
        "SVGD": (logp, 8, 2),
        "pathfinder": (logp, np.zeros(2)),
        "multi_pathfinder": (logp, 4, np.zeros(2)),
        "find_map": (logp, np.zeros(2)),
    }[name]
    with pytest.raises(RuntimeError, match="is_available"):
        getattr(mt, name)(*args)


# the time-series layer
SLICE9_MODULES = ("ops/scan.py", "utils/buffers.py", "models/lgss.py",
                  "models/hmm.py", "particle.py", "rbpf.py", "if2.py",
                  "ibis.py", "smc2.py", "enkf.py", "ukf.py", "eks.py",
                  "examples/state_space.py", "examples/ssm_mle.py",
                  "examples/regime_switching.py", "examples/streaming.py",
                  "examples/data_assimilation.py")
# the JAX package's exports of these modules (mcmcpp_tpu/__init__.py:46-65,
# :92-105)
SLICE9_NAMES = ("IBISSampler", "IF2Result", "if2", "EKIResult", "EKSResult",
                "ensemble_kalman_inversion", "ensemble_kalman_sampler",
                "UKFModel", "UKFResult", "unscented_kalman_filter",
                "unscented_rts_smoother", "SMC2Sampler", "RaoBlackwellSSM",
                "rao_blackwell_filter", "rbpf_forecast", "switching_model",
                "EnKFModel", "ensemble_kalman_filter", "ParticleGibbsKernel",
                "PMMHSampler", "StateSpaceModel", "particle_filter",
                "particle_forecast", "particle_smoother",
                "ibis_to_inference_dict", "smc2_to_inference_dict")


def test_time_series_modules_import_no_jax_or_triton():
    files = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(SLICE9_MODULES) <= files
    mods = [m[:-3].replace("/", ".") for m in SLICE9_MODULES]
    code = ("import sys\n"
            + "".join(f"import mcmcpp_tpu_torch.{m}\n" for m in mods)
            + "bad = [m for m in ('jax', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_exports_the_jax_packages_time_series_names():
    import mcmcpp_tpu_torch as mt
    from mcmcpp_tpu_torch import models

    for name in SLICE9_NAMES:
        assert name in mt.__all__ and getattr(mt, name) is not None
    assert {"lgss", "hmm"} <= set(models.__all__)
    from mcmcpp_tpu_torch.io.checkpoint import FOR_SAMPLER

    assert {"pmmh", "ibis", "smc2"} <= set(FOR_SAMPLER)


@pytest.mark.parametrize("build", [
    lambda mt: mt.PMMHSampler(None, None, lambda t: t[0], 1,
                              loglik_fn=lambda g, t: t[0]),
    lambda mt: mt.IBISSampler(lambda t: t[0], lambda t, y: t[0], None, 8, 1),
    lambda mt: mt.SMC2Sampler(None, lambda t: t[0], None, 8, 1),
    lambda mt: mt.particle_filter(0, None, None, [0.0], 8),
    lambda mt: mt.rao_blackwell_filter(0, None, [0.0], 8),
    lambda mt: mt.ensemble_kalman_filter(0, None, [0.0], 8),
    lambda mt: mt.if2(0, None, [0.0], 8, [0.0], 0.1),
    lambda mt: mt.models.lgss.lgss_params(1, 0, 1, 1, 0, 1, 0, 1),
], ids=["pmmh", "ibis", "smc2", "particle_filter", "rbpf", "enkf", "if2",
        "lgss_params"])
def test_time_series_entry_points_on_cuda_without_gpu_raise(build):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    import mcmcpp_tpu_torch as mt

    with pytest.raises(RuntimeError, match="is_available"):
        build(mt)


# numpy inputs on the card, the native chain arena, the eight example
# programs
SLICE10_MODULES = ("native/__init__.py", "examples/dp_mixture.py",
                   "examples/tempering_and_dsl.py",
                   "examples/bayesian_workflow.py", "examples/evidence.py",
                   "examples/function_space.py", "examples/gp_hyperparams.py",
                   "examples/gp_latent.py", "examples/gradient_inference.py")


def test_slice10_modules_import_no_jax_or_triton():
    """The new modules exist (so the source scan above covers them) and
    import neither JAX, the JAX package nor triton; the native arena's C++
    source is the port's own copy."""
    from mcmcpp_tpu_torch import native

    files = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(SLICE10_MODULES) <= files
    for src in (native.SOURCE, native.TEST_SOURCE):
        assert src.parent == PKG / "native" and src.exists()
    mods = [m[:-3].replace("/", ".").removesuffix(".__init__")
            for m in SLICE10_MODULES]
    code = ("import sys\n"
            + "".join(f"import mcmcpp_tpu_torch.{m}\n" for m in mods)
            + "bad = [m for m in ('jax', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


PARALLEL_MODULES = ("parallel/__init__.py", "parallel/distributed.py",
                    "parallel/mesh.py", "parallel/sharded.py")
# the engines that take ``mesh=`` since the sharded-engines slice
MESH_ENGINE_MODULES = ("gradient/hmc.py", "gradient/nuts.py",
                       "gradient/chees.py", "gradient/meads.py",
                       "gradient/barker.py", "gradient/sgmcmc.py",
                       "gradient/mclmc.py", "tempering.py", "gibbs.py",
                       "smc.py", "pcn.py", "elliptical.py", "nested.py",
                       "io/checkpoint.py")


def test_parallel_modules_import_no_jax_or_triton():
    """The multi-device layer and the engines that take ``mesh=`` exist (so
    the source scan above covers them) and importing them pulls in neither
    JAX, the JAX package nor triton, and starts no process group."""
    files = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(PARALLEL_MODULES + MESH_ENGINE_MODULES) <= files
    engines = "".join(
        f"import mcmcpp_tpu_torch.{m[:-3].replace('/', '.')}\n"
        for m in MESH_ENGINE_MODULES)
    code = ("import sys, torch\n"
            "import mcmcpp_tpu_torch.parallel.sharded\n"
            + engines +
            "import mcmcpp_tpu_torch.parallel.distributed as d\n"
            "assert not torch.distributed.is_initialized()\n"
            "assert d.world_size() == 1 and not d.is_multihost()\n"
            "bad = [m for m in ('jax', 'triton', 'mcmcpp_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_exports_the_jax_packages_subpackages_but_parallel():
    """The JAX package's whole ``__all__``: since the multi-device slice it
    lacks nothing, ``parallel`` and its three names included."""
    import mcmcpp_tpu_torch as mt

    for name in ("gradient", "io", "ops", "analysis", "models", "dsl",
                 "parallel"):
        assert name in mt.__all__ and getattr(mt, name) is not None
    init = (REPO / "mcmcpp_tpu" / "__init__.py").read_text()
    tree = ast.parse(init)
    jax_all = next(
        node.value for node in tree.body if isinstance(node, ast.Assign)
        and any(getattr(t, "id", None) == "__all__" for t in node.targets))
    names = {ast.literal_eval(e) for e in jax_all.elts}
    assert names - set(mt.__all__) == set()


# (JAX class, port class) of each engine that defines ``mesh=``; the
# gradient samplers' subclasses take it through their base
MESH_ENGINES = [
    ("gradient.hmc", "GradientSampler"),
    ("gradient.sgmcmc", "StochasticGradientSampler"),
    ("gradient.mclmc", "MCLMCSampler"),
    ("tempering", "ParallelTemperingSampler"),
    ("gibbs", "BlockedGibbsSampler"),
    ("smc", "SMCSampler"),
    ("pcn", "PCNSampler"),
    ("elliptical", "EllipticalSliceSampler"),
    ("nested", "NestedSampler"),
]


@pytest.mark.parametrize("module,cls", MESH_ENGINES)
def test_engines_take_mesh_with_the_jax_signature(module, cls):
    """Each engine's constructor takes ``mesh=`` (default None) as the JAX
    package's does, after the JAX constructor's parameters before it, in
    their order."""
    import importlib
    import inspect

    j = inspect.signature(getattr(importlib.import_module(
        f"mcmcpp_tpu.{module}"), cls).__init__).parameters
    t = inspect.signature(getattr(importlib.import_module(
        f"mcmcpp_tpu_torch.{module}"), cls).__init__).parameters
    assert j["mesh"].default is None and t["mesh"].default is None
    before = list(j)[:list(j).index("mesh")]
    assert [p for p in t if p in before] == before


@pytest.mark.parametrize("name", [
    "HMCSampler", "MALASampler", "BarkerSampler", "NUTSSampler",
    "CheesHMCSampler", "MEADSSampler", "SGHMCSampler", "MAMSSampler"])
def test_engine_subclasses_pass_mesh_on(name):
    """The subclasses' constructors pass ``mesh=`` to their base: built on a
    layout of one rank they hold every chain, on its device."""
    from tests.torch_sharded_engine_cases import run_in_threads

    cls = getattr(mcmcpp_tpu_torch, name)

    def build(layout):
        if name == "SGHMCSampler":
            return cls(lambda t: t[:, 0], lambda t, b: t[:, 0], np.zeros(
                (8, 2)), 16, 2, batch_size=4, mesh=layout)
        return cls(lambda t: -torch.sum(t * t, -1), 16, 2, mesh=layout)

    s, = run_in_threads(1, build)
    assert s.mesh is not None and s.device == torch.device("cpu")
    assert s._n_local == 16
