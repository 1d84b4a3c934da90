"""Multi-device tests on the virtual 8-device CPU mesh.

Checks that the (data, model)-sharded discretize+flux step produces exactly
the same flux matrix as the single-device fused step and the host reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from msm_we_tpu.parallel import (
    build_sharded_step,
    fused_step_single,
    make_mesh,
    steady_state_from_flux,
)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    N, d, n_bins, k = 256, 8, 4, 4
    K = n_bins * k
    X_p = rng.normal(size=(N, d)).astype(np.float32)
    X_c = rng.normal(size=(N, d)).astype(np.float32)
    pbins = rng.integers(0, n_bins, N).astype(np.int32)
    cbins = rng.integers(0, n_bins, N).astype(np.int32)
    w = rng.random(N).astype(np.float32)
    basis_p = rng.random(N) < 0.1
    basis_c = rng.random(N) < 0.05
    target_c = rng.random(N) < 0.05
    centers = rng.normal(size=(K, d)).astype(np.float32)
    center_bin = np.repeat(np.arange(n_bins, dtype=np.int32), k)
    holey = rng.random(K) < 0.9  # simulate cleaned-away centers
    # Compact bank (the kernel contract): valid centers first, in
    # global-id order, so the argmin row IS the global cluster id
    rows = np.flatnonzero(holey)
    centers = centers[rows]
    center_bin = center_bin[rows]
    valid = np.ones(len(rows), bool)
    n_states = len(rows) + 2
    return dict(
        fp=X_p, fc=X_c, pbins=pbins, cbins=cbins,
        basis_p=basis_p, basis_c=basis_c, target_c=target_c, w=w,
        centers=centers, center_bin=center_bin, valid=valid,
        n_states=n_states,
    )


def _host_reference(p):
    """Brute-force numpy version of the fused step."""
    def assign(X, bins):
        d2 = ((X[:, None, :] - p["centers"][None]) ** 2).sum(-1)
        ok = p["valid"][None, :] & (p["center_bin"][None, :] == bins[:, None])
        d2[~ok] = np.inf
        return d2.argmin(1)  # compact bank: row == global id

    pidx = assign(p["fp"], p["pbins"])
    cidx = assign(p["fc"], p["cbins"])
    n = p["n_states"]
    cidx = np.where(p["target_c"], n - 1, cidx)
    pidx = np.where(p["basis_p"], n - 2, pidx)
    cidx = np.where(p["basis_c"], n - 2, cidx)
    fm = np.zeros((n, n))
    np.add.at(fm, (pidx, cidx), p["w"])
    return fm


def test_single_device_fused_matches_host(problem):
    p = problem
    fm, _, _ = fused_step_single(
        p["fp"], p["fc"], p["pbins"], p["cbins"],
        p["basis_p"], p["basis_c"], p["target_c"], p["w"],
        p["centers"], p["center_bin"], p["valid"],
        p["n_states"],
    )
    assert np.allclose(np.asarray(fm), _host_reference(p), atol=1e-5)


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_sharded_matches_single(problem, model_parallel):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    p = problem
    mesh = make_mesh(jax.devices()[:8], model_parallel=model_parallel)
    step = build_sharded_step(mesh, p["n_states"], n_bins=int(p["center_bin"].max()) + 1)
    # Pad the center bank so it divides the model axis
    K = len(p["centers"])
    mp = model_parallel
    pad = (-K) % mp
    centers = np.concatenate([p["centers"], np.zeros((pad, p["centers"].shape[1]), np.float32)])
    center_bin = np.concatenate([p["center_bin"], np.full(pad, -2, np.int32)])
    valid = np.concatenate([p["valid"], np.zeros(pad, bool)])

    fm = step(
        p["fp"], p["fc"], p["pbins"], p["cbins"],
        p["basis_p"], p["basis_c"], p["target_c"], p["w"],
        centers, center_bin, valid,
    )
    assert np.allclose(np.asarray(fm), _host_reference(p), atol=1e-5)


def test_steady_state_from_flux(problem):
    p = problem
    fm = jnp.asarray(_host_reference(p), jnp.float32)
    n = p["n_states"]
    basis_mask = jnp.arange(n) == n - 2
    target_mask = jnp.arange(n) == n - 1
    T, pss, flux, residual = steady_state_from_flux(fm, basis_mask, target_mask)
    assert np.allclose(np.asarray(T).sum(1), 1.0, atol=1e-5)
    assert np.isclose(float(np.asarray(pss).sum()), 1.0, atol=1e-5)
    assert float(flux) >= 0
    assert float(residual) < 1e-5


def test_multihost_style_ingest():
    """Per-'host' local shards assembled via make_array_from_single_device_
    arrays must produce the identical flux matrix to the single-array path
    (the multi-host ingest boundary, docs/multihost.md)."""
    import os
    import sys

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    import __graft_entry__ as graft

    graft.dryrun_multihost(8)


def test_steady_state_slow_mixing_converges():
    """A nearly-reducible chain (mixing time >> the fixed 512 powers) must
    still converge: the residual-checked while_loop keeps squaring
    (round-2 VERDICT item 6)."""
    eps = 1e-5
    fm = np.array(
        [
            [0.5, 0.5, eps, 0.0],
            [0.5, 0.5, 0.0, 0.0],
            [0.0, 0.0, 0.5, 0.5],
            [3 * eps, 0.0, 0.5, 0.5],
        ],
        np.float32,
    )
    basis_mask = jnp.zeros(4, bool)
    target_mask = jnp.zeros(4, bool)
    # Without the residual-checked extension, 512 powers leave the chain
    # unconverged: the one-step residual scales with gap * deviation, so it
    # is small in absolute terms but still above tol -- which is exactly
    # what triggers the extension loop.
    _T0, _p0, _f0, residual_fixed = steady_state_from_flux(
        fm, basis_mask, target_mask, max_extra_squarings=0
    )
    assert float(residual_fixed) > 5e-6
    # ...with it, the tail converges to tol.
    T, pss, _flux, residual = steady_state_from_flux(
        fm, basis_mask, target_mask
    )
    assert float(residual) < 1e-6
    # Cross-check against a dense f64 eigensolve of the same T. The
    # achievable accuracy is gap-limited (|err| ~ residual / spectral gap;
    # the gap here is ~2e-5), so the bound is loose but still far tighter
    # than the unconverged fixed-power answer.
    Th = np.asarray(T, np.float64)
    vals, vecs = np.linalg.eig(Th.T)
    p_ref = np.real(vecs[:, np.argmax(np.real(vals))])
    p_ref = np.abs(p_ref) / np.abs(p_ref).sum()
    assert np.allclose(np.asarray(pss), p_ref, atol=0.05)
    err_converged = np.abs(np.asarray(pss) - p_ref).max()
    err_fixed = np.abs(np.asarray(_p0) - p_ref).max()
    assert err_converged < err_fixed / 3


def test_packed_flux_roundtrip_golden():
    """Pack/unpack must be a bitwise round trip for normal-range f64 --
    pinned with values exercising sign and exponent extremes down to the
    smallest normal. (f64 *sub*normals flush to zero in XLA device
    compares -- DAZ -- so they are documented as out of scope for the
    packed tier; see _pack_flux.)"""
    from msm_we_tpu.parallel.sharded import (
        _pack_flux, flux_pack_capacity, unpack_packed_flux,
    )
    from msm_we_tpu.utils import _scoped_x64

    S = 100
    fm = np.zeros((S, S), np.float64)
    fm[0, 1] = 1.5
    fm[3, 97] = -2.25e-300
    fm[42, 42] = 1e250
    fm[99, 0] = np.finfo(np.float64).tiny  # smallest NORMAL f64
    fm[7, 7] = np.pi
    cap = flux_pack_capacity(S)
    with _scoped_x64():
        buf = np.asarray(jax.jit(lambda m: _pack_flux(m, cap))(jnp.asarray(fm)))
    out = unpack_packed_flux(buf, S, cap)
    np.testing.assert_array_equal(out, fm)


def test_packed_flux_overflow_returns_none():
    from msm_we_tpu.parallel.sharded import _pack_flux, unpack_packed_flux
    from msm_we_tpu.utils import _scoped_x64

    S = 64
    fm = np.arange(1, S * S + 1, dtype=np.float64).reshape(S, S)  # all nonzero
    cap = 512  # < S*S nonzeros
    with _scoped_x64():
        buf = np.asarray(jax.jit(lambda m: _pack_flux(m, cap))(jnp.asarray(fm)))
    assert unpack_packed_flux(buf, S, cap) is None


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_sharded_step_packed_matches_dense(problem, model_parallel):
    """The packed-sparse program must reproduce the dense program's flux
    matrix BITWISE (same scatter, lossless packing)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from msm_we_tpu.parallel.sharded import (
        build_sharded_step_packed, flux_pack_capacity, unpack_packed_flux,
    )
    from msm_we_tpu.utils import _scoped_x64

    p = problem
    n_bins = int(p["center_bin"].max()) + 1
    mesh = make_mesh(jax.devices()[:8], model_parallel=model_parallel)
    K = len(p["centers"])
    pad = (-K) % model_parallel
    centers = np.concatenate(
        [p["centers"], np.zeros((pad, p["centers"].shape[1]), np.float32)]
    )
    center_bin = np.concatenate([p["center_bin"], np.full(pad, -2, np.int32)])
    valid = np.concatenate([p["valid"], np.zeros(pad, bool)])
    w64 = p["w"].astype(np.float64)

    dense = build_sharded_step(mesh, p["n_states"], n_bins=n_bins)
    packed = build_sharded_step_packed(mesh, p["n_states"], n_bins=n_bins)
    args = (
        p["fp"], p["fc"], p["pbins"], p["cbins"],
        p["basis_p"], p["basis_c"], p["target_c"], w64,
        centers, center_bin, valid,
    )
    with _scoped_x64():
        fm_dense = np.asarray(dense(*args), dtype=np.float64)
        buf = np.asarray(packed(*args))
    fm_packed = unpack_packed_flux(
        buf, p["n_states"], flux_pack_capacity(p["n_states"])
    )
    np.testing.assert_array_equal(fm_packed, fm_dense)


def test_device_f64_weight_guard(monkeypatch):
    """The default f64 device accumulation takes any WE weight; only the
    opt-in f32 tier refuses weights outside the f32 exponent range."""
    from msm_we_tpu.model import modelWE

    m = object.__new__(modelWE)

    def guard(weights):
        return modelWE._device_f64_weights_ok(m, np.asarray(weights))

    tiny = np.array([1e-250, 0.5])
    monkeypatch.delenv("MSM_WE_TPU_DEVICE_FLUX_F32", raising=False)
    assert guard(tiny)  # native f64: anything goes
    assert guard(np.array([1e250, 0.5]))
    monkeypatch.setenv("MSM_WE_TPU_DEVICE_FLUX_F32", "1")
    assert not guard(tiny)  # below f32 tiny -> host fallback
    assert not guard(np.array([1e39]))  # above f32 max
    assert guard(np.array([1e-30, 0.5]))  # inside f32 range
    assert guard(np.array([0.0]))  # all-zero: nothing to flush


@pytest.mark.parametrize("model_parallel", [1, 2])
def test_combined_step_matches_separate_programs(problem, model_parallel):
    """The combined flux+ids program must reproduce BOTH the dense flux
    program's matrix (bitwise) and the pair-assign program's predict-order
    ids (including a distinct ids_n_states numbering)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from msm_we_tpu.parallel.sharded import (
        build_sharded_pair_assign, build_sharded_step_packed_with_ids,
        flux_pack_capacity, unpack_packed_flux,
    )
    from msm_we_tpu.utils import _scoped_x64

    p = problem
    n_bins = int(p["center_bin"].max()) + 1
    mesh = make_mesh(jax.devices()[:8], model_parallel=model_parallel)
    K = len(p["centers"])
    pad = (-K) % model_parallel
    centers = np.concatenate(
        [p["centers"], np.zeros((pad, p["centers"].shape[1]), np.float32)]
    )
    center_bin = np.concatenate([p["center_bin"], np.full(pad, -2, np.int32)])
    valid = np.concatenate([p["valid"], np.zeros(pad, bool)])
    w64 = p["w"].astype(np.float64)
    target_p = np.zeros(len(w64), bool)
    ids_n_states = p["n_states"] - 1  # exercise a numbering that differs

    dense = build_sharded_step(
        mesh, p["n_states"], with_target_p=True, n_bins=n_bins
    )
    assign = build_sharded_pair_assign(
        mesh, ids_n_states, with_target_p=True, n_bins=n_bins
    )
    combined = build_sharded_step_packed_with_ids(
        mesh, p["n_states"], ids_n_states, with_target_p=True, n_bins=n_bins
    )
    flux_args = (
        p["fp"], p["fc"], p["pbins"], p["cbins"],
        p["basis_p"], p["basis_c"], p["target_c"], w64,
        centers, center_bin, valid, target_p,
    )
    assign_args = (
        p["fp"], p["fc"], p["pbins"], p["cbins"],
        p["basis_p"], p["basis_c"], p["target_c"],
        centers, center_bin, valid, target_p,
    )
    with _scoped_x64():
        fm_dense = np.asarray(dense(*flux_args), dtype=np.float64)
        ids_ref = np.asarray(assign(*assign_args))
        buf, ids = combined(*flux_args)
        buf = np.asarray(buf)
        ids = np.asarray(ids)
    fm_combined = unpack_packed_flux(
        buf, p["n_states"], flux_pack_capacity(p["n_states"])
    )
    np.testing.assert_array_equal(fm_combined, fm_dense)
    np.testing.assert_array_equal(ids, ids_ref)
