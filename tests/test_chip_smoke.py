"""chip_smoke.py's phases at tiny shapes on the CPU's virtual devices.

On the GPU the script runs the same functions at full width; here they run
small enough for the suite, so a refactor that breaks a phase or its
comparison fails on the CPU first.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402
import chip_smoke  # noqa: E402

# 90 atoms = 270 raw dims: above DEVICE_MOMENTS_MIN_DIM, so the PCA moments
# run as device programs, as they do at 900 dims on the GPU; and 3,600 rows
# x 270 x 30 components is above _DEVICE_TRANSFORM_MIN_FLOPS, so the PCA
# transform does too
TINY = dict(n_iterations=12, n_segments=300, n_atoms=90, n_components=30,
            seed=17)


@pytest.fixture(scope="module")
def built():
    model, dataset = chip_smoke.phase_build(TINY, "cpu")
    return model, dataset


def test_phase_build_runs_device_stages(built, capsys):
    model, _dataset = built
    assert np.isfinite(model.JtargetSS) and model.JtargetSS > 0
    assert model.ndim >= 1


def test_phase_build_reports_stages(capsys):
    chip_smoke.phase_build(TINY, "cpu")
    out = capsys.readouterr().out
    assert "Dimensionality reduction ran device programs" in out
    assert "Clustering ran device programs" in out
    assert "PCA transform (jit__project) ran on the device" in out
    assert "FAIL" not in out


def test_phase_reference_layers(built, capsys):
    model, dataset = built
    chip_smoke.phase_reference(model, dataset, TINY, "cpu")
    out = capsys.readouterr().out
    for tag in ("b.1", "b.2", "b.3", "b.4"):
        assert tag in out
    assert "FAIL" not in out


def test_phase_deep_split(built, capsys):
    model, _dataset = built
    chip_smoke.phase_deep_split(model)
    out = capsys.readouterr().out
    assert "sends it to the device: True" in out and "FAIL" not in out


def test_phase_hot_step(capsys):
    p = bench.make_problem(
        n_segments=2048, n_raw_features=40, n_components=8, n_bins=4,
        k_per_bin=5, seed=3,
    )
    chip_smoke.phase_hot_step(p, "cpu", n_trials=2)
    out = capsys.readouterr().out
    assert "memory_analysis" in out
    assert "change at Precision.DEFAULT" in out
    assert "FAIL" not in out


def test_phase_fpt(capsys):
    chip_smoke.phase_fpt(n_states=60, max_n_lags=15)
    assert "FAIL" not in capsys.readouterr().out


def test_compare_assignments_rejects_a_real_disagreement():
    X = np.array([[0.0, 0.0], [3.0, 0.0]], np.float32)
    C = np.array([[0.0, 0.0], [4.0, 0.0]], np.float32)
    bins = np.zeros(2, np.int32)
    cb = np.zeros(2, np.int32)
    valid = np.ones(2, bool)
    chip_smoke.compare_assignments("ok", X, bins, C, cb, valid, np.array([0, 1]))
    with pytest.raises(AssertionError):
        chip_smoke.compare_assignments(
            "wrong", X, bins, C, cb, valid, np.array([1, 1])
        )


def test_four_gpu_comparisons_on_virtual_devices(capsys):
    devices = jax.devices()[:4]
    chip_smoke.phase_four_gpus(devices, TINY, n_rows=4096)
    out = capsys.readouterr().out
    assert "flux matrix bitwise equal" in out and "FAIL" not in out


def test_main_refuses_a_non_gpu_platform(capsys):
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs a GPU" in captured.err


def test_result_line_format():
    ident = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.result_line(ident)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(line) == {"ok": True, "device": ident}


def test_tf32_rounds_to_a_10_bit_mantissa():
    one = 1.0
    assert chip_smoke.tf32(one + 2.0**-12) == one  # below half an ulp
    assert chip_smoke.tf32(one + 2.0**-10) == one + 2.0**-10  # representable
    assert chip_smoke.tf32(one + 3 * 2.0**-12) == one + 2.0**-10  # rounds up
    assert chip_smoke.tf32(np.float64(0.1)).dtype == np.float64


def test_compare_stored_ids_rejects_a_corrupted_id(built, capsys):
    model, _dataset = built
    chip_smoke.compare_stored_ids(model)
    assert "FAIL" not in capsys.readouterr().out
    strat = model._strat
    _C, cb, valid = strat.compact_bank()
    masks = model._pc_masks()
    free = ~(masks["basis_c"] | masks["target_c"])
    stored = model._child_idx
    row = int(np.flatnonzero(free)[0])
    same_bin = np.flatnonzero(valid & (cb == cb[stored[row]]))
    other = int(same_bin[same_bin != stored[row]][0])
    was = int(stored[row])
    try:
        stored[row] = other
        with pytest.raises(AssertionError, match="b.1 child"):
            chip_smoke.compare_stored_ids(model)
    finally:
        stored[row] = was
