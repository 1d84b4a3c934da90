"""Smoke-test bench.py's machinery at tiny shapes on CPU.

A refactor that breaks its step builders or measurement plumbing would
only show on the GPU; this exercises every tier's step builder, the
flops/bytes model, the peaks table and the GPU guard without a card or
full-size arrays.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402


@pytest.fixture(scope="module")
def problem():
    return bench.make_problem(
        n_segments=256, n_raw_features=40, n_components=8,
        n_bins=4, k_per_bin=5, seed=3,
    )


@pytest.mark.parametrize("tier", ["direct", "fast_math", "dedup"])
def test_device_pipeline_tiers_run(problem, tier):
    import jax

    step, args = bench.device_pipeline(
        problem,
        fast_math=(tier == "fast_math"),
        dedup=(tier == "dedup"),
    )
    fm, pss, flux, residual = step(*[jax.device_put(a) for a in args])
    fm = np.asarray(fm)
    assert np.isfinite(fm).all() and fm.sum() > 0
    assert np.isclose(float(np.asarray(pss).sum()), 1.0, atol=1e-4)
    assert float(flux) >= 0
    assert np.isfinite(float(residual))


def test_dedup_tier_flux_matches_direct(problem):
    import jax

    step, args = bench.device_pipeline(problem)
    fm, *_ = step(*[jax.device_put(a) for a in args])
    step_dd, args_dd = bench.device_pipeline(problem, dedup=True)
    fm_dd, *_ = step_dd(*[jax.device_put(a) for a in args_dd])
    np.testing.assert_allclose(np.asarray(fm_dd), np.asarray(fm), atol=1e-6)


def test_step_flops_bytes_model(problem):
    flops, bytes_moved = bench.step_flops_bytes(problem)
    flops_dd, bytes_dd = bench.step_flops_bytes(problem, dedup=True)
    assert flops > flops_dd > 0
    assert bytes_moved > bytes_dd > 0


def test_time_step_reports_min_and_median(problem):
    import jax

    step, args = bench.device_pipeline(problem)
    t_min, t_med, out = bench.time_step(
        step, [jax.device_put(a) for a in args], n_trials=3
    )
    assert 0 < t_min <= t_med
    assert np.asarray(out[0]).shape == (problem["n_states"],) * 2


def test_device_peaks_known_and_unknown():
    flops, bw = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert flops == 67e12 and bw == 3.35e12
    with pytest.raises(ValueError, match="No peak rates"):
        bench.device_peaks("cpu")


def test_bench_refuses_a_non_gpu_device():
    # conftest pins the CPU backend: the bench must stop, not fall back
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench.main()
