"""What the package needs to run on a GPU install: the array-backed
dataset, the optional packages it must run without, the compile-cache
helper, device selection, and the device flux route for any WE weight."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from msm_we_tpu.binning import RectilinearBinMapper  # noqa: E402
from msm_we_tpu.data import (  # noqa: E402
    SynthWESettings,
    WEDataset,
    generate_trajectory_arrays,
    generate_west_h5,
)
from msm_we_tpu.model import modelWE  # noqa: E402


def _build(source, mesh_devices=None):
    model = modelWE()
    if mesh_devices is not None:
        from msm_we_tpu.parallel import make_mesh

        model.enable_mesh(make_mesh(mesh_devices))
    model.build_analyze_model(
        file_paths=source,
        ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="t",
        basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method="pca",
        tau=1.0,
        n_clusters=3,
        cross_validation_groups=0,
        show_live_display=False,
        device_pipeline=mesh_devices is not None,
        step_kwargs={"clustering": {
            "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 6)])
        }},
    )
    return model


@pytest.fixture(scope="module")
def iterations():
    return generate_trajectory_arrays(
        SynthWESettings(n_iterations=21, n_segments=24, warmup=20, seed=5)
    )


def test_array_dataset_matches_west_h5(tmp_path, iterations):
    path = str(tmp_path / "west.h5")
    generate_west_h5(path, n_iterations=20, n_segments=24, seed=5)
    from_file = _build([path])
    from_arrays = _build(WEDataset.from_arrays(iterations))
    for key in ("parent", "child", "weights", "pcoord0", "pcoord1"):
        np.testing.assert_array_equal(
            from_arrays._features[key], from_file._features[key]
        )
    assert from_arrays.JtargetSS == from_file.JtargetSS
    assert from_arrays.fileList == []


def test_array_dataset_reads_are_copies(iterations):
    ds = WEDataset.from_arrays(iterations)
    block = ds._iter_frame_block(3, -1, consume=True)
    block[:] = np.nan
    assert np.isfinite(iterations[2]["coords"][:, -1]).all()
    assert ds.maxIter == len(iterations) - 1


def test_initialize_rejects_mismatched_dataset(iterations):
    ds = WEDataset.from_arrays(iterations, auxpath="coord")
    with pytest.raises(ValueError, match="auxpath"):
        modelWE().initialize(ds, None, "m", auxpath="other",
                             _suppress_boundary_warning=True)


def test_deep_split_weights_take_the_device_flux_route(iterations):
    """WE weights near 1e-250: the device f64 scatter on a CPU mesh must
    equal the host bincount, on the same assignments."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    model = _build(WEDataset.from_arrays(iterations), jax.devices()[:4])
    fm_dev, fm_host = chip_smoke.flux_device_vs_host(model, weight_scale=1e-250)
    assert 0 < np.abs(fm_host).max() < 1e-240
    np.testing.assert_allclose(fm_dev, fm_host, rtol=0,
                               atol=1e-12 * np.abs(fm_host).max())


def test_f32_tier_guard_sends_tiny_weights_to_host(monkeypatch, caplog,
                                                   iterations):
    import logging

    from msm_we_tpu._logging import log as pkg_log

    model = _build(WEDataset.from_arrays(iterations), jax.devices()[:2])
    w = model._featurize_all()["weights"] * 1e-250
    assert model._device_f64_weights_ok(w)
    monkeypatch.setenv("MSM_WE_TPU_DEVICE_FLUX_F32", "1")
    pkg_log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="msm_we_tpu"):
            assert not model._device_f64_weights_ok(w)
    finally:
        pkg_log.removeHandler(caplog.handler)
    assert "MSM_WE_TPU_DEVICE_FLUX_F32" in caplog.text
    # The flux comparison notices when the guard keeps the device route off
    sys.path.insert(0, ROOT)
    import chip_smoke

    with pytest.raises(AssertionError, match="did not run"):
        chip_smoke.flux_device_vs_host(model, weight_scale=1e-250)


def test_runs_without_optional_packages():
    """h5py, networkx, rich, sklearn and matplotlib blocked: the package,
    modelWE and an array-backed build still work."""
    code = """
import sys
for name in ("h5py", "networkx", "rich", "sklearn", "matplotlib"):
    sys.modules[name] = None
import numpy as np
import msm_we_tpu
from msm_we_tpu import modelWE
from msm_we_tpu.binning import RectilinearBinMapper
from msm_we_tpu.data import SynthWESettings, WEDataset, generate_trajectory_arrays
its = generate_trajectory_arrays(
    SynthWESettings(n_iterations=21, n_segments=24, warmup=20, seed=5))
m = modelWE()
m.build_analyze_model(
    file_paths=WEDataset.from_arrays(its),
    ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
    modelName="t", basis_pcoord_bounds=[[9.0, 10.0]],
    target_pcoord_bounds=[[0.0, 1.0]], dimreduce_method="pca", tau=1.0,
    n_clusters=3, cross_validation_groups=0, show_live_display=False,
    step_kwargs={"clustering": {
        "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 6)])}})
assert np.isfinite(m.JtargetSS)
assert "h5py" not in [k for k, v in sys.modules.items() if v is not None]
print("ok", m.JtargetSS)
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_compilation_cache_uses_the_variable_when_set(monkeypatch, tmp_path):
    from msm_we_tpu.utils import enable_compilation_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # set nothing


def test_compilation_cache_defaults_into_the_checkout(monkeypatch):
    from msm_we_tpu.utils import enable_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compilation_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert os.path.isdir(path)
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compilation_cache_leaves_an_installed_package_alone(monkeypatch):
    from msm_we_tpu import utils

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(utils, "_checkout_root", lambda: None)
    before = jax.config.jax_compilation_cache_dir
    assert utils.enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_select_devices_never_substitutes(monkeypatch):
    sys.path.insert(0, ROOT)
    import __graft_entry__ as graft

    assert len(graft._select_devices(4)) == 4
    with pytest.raises(RuntimeError, match="Needed 64 devices"):
        graft._select_devices(64)


def test_fundamental_sequence_shortest_path():
    from msm_we_tpu.msm.ensembles import DiscretePathEnsemble as E

    m = np.array([
        [0.0, 0.9, 0.1, 0.0],
        [0.0, 0.0, 0.0, 0.9],
        [0.0, 0.0, 0.0, 0.1],
        [0.0, 0.0, 0.0, 0.0],
    ])
    g = E._graph_from_matrix(m)
    assert E._shortest_path(g, 0, 3) == [0, 1, 3]
    with pytest.raises(ValueError, match="No path"):
        E._shortest_path(g, 3, 0)
