#!/usr/bin/env python
"""Smoke run of the haMSM build on one GPU, checked against plain references.

Run from the root of a checkout::

    python chip_smoke.py              # phases a-e on one GPU
    python chip_smoke.py --four-gpus  # the ('data', 'model') mesh on 4 GPUs

One process drives the card; JAX's default device must be a GPU, or the
script exits non-zero before any phase runs. Phases (each prints its result,
its comparison, the tolerance and the matmul precision, and any failure
exits non-zero):

a. **Build** -- ``build_analyze_model(device_pipeline=True)`` on a seeded
   synthetic WE dataset at NTL9 width (``bench.BUILD``: 101 iterations x
   1,000 segments, 300 atoms = 900 raw dims, PCA to 30 components, 12 WE
   bins x 25 clusters), cold then warm, then once more under the profiler
   to show which stages ran device programs: the PCA moments, the PCA
   transform and the clustering must.
b. **Layered reference** -- the parent and child ids the build stored
   against a numpy f64 argmin on the model's own features and centers; the
   device f64 flux scatter against the host f64 bincount on the same
   assignments; the device steady state against the host f64 tail on the
   same flux matrix; and the whole build on the CPU (reported, not gated).
c. **Deep-split weights** -- the device f64 flux with WE weights scaled to
   ~1e-250 against the host bincount.
d. **Hot step** -- the fused transform -> assign -> flux -> steady-state
   step at 102,400 segments x 900 dims -> 30 components x 250 centers:
   compiled memory, XLA's time on the card, assignments against numpy f64,
   and the share of assignments that change at default (TF32) precision.
e. **FPT engines** -- the device F-matrix recursion and vector-power engine
   at 1,000 states against the host f64 ``MatrixFPT``.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import argparse
import copy
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# The fused hot step (bench.make_problem defaults)
HOT_STEP = dict(n_segments=102_400, n_raw_features=900, n_components=30,
                n_bins=10, k_per_bin=25)
FPT_STATES = 1000

# Tolerances, each with its reason. The f32 engines' limits sit 10-100
# times above what they read on an H100 at Precision.HIGHEST (in the
# comments), and at least 10 times below what rounding the same matrix to
# TF32's 10-bit mantissa does to the host f64 answer (each phase prints
# and gates that), so a reduced-precision (TF32, Precision.DEFAULT)
# engine fails them.
ASSIGN_GAP_REL = 1e-5  # f32 score rounding: |x|^2 + |c|^2 times ~100 eps32
FLUX_F64_RTOL = 1e-12  # f64 scatter order (GPU atomics) vs bincount
FLUX_F32_RTOL = 1e-5  # the hot step scatters its f32 weights in f32
SS_P_ATOL = 1e-6  # f32 powering vs host f64 on pSS: read 1.8e-8; TF32 2.8e-4
SS_J_RTOL = 1e-5  # ... on the target flux: read 1.1e-7; TF32 2.1e-3
FPT_RTOL = 1e-5  # F-matrix recursion vs f64 / peak: read 7.5e-7; TF32 1.8e-4
VPOW_RTOL = 5e-4  # vector powers to T^12345 / max: read 5.2e-5; TF32 4.8e-3
MESH_J_RTOL = 1e-6  # 4-GPU vs 1-GPU build: cross-shard argmin combine


def log(msg=""):
    print(msg, flush=True)


def check(label, value, limit, ok):
    """Print ``label: value (limit) ok|FAIL`` and raise when not ``ok``."""
    log(f"  {label}: {value} ({limit}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: {value} ({limit})")


def result_line(ident):
    """The last line of standard output."""
    return json.dumps({"ok": True, "device": ident})


def peak_bytes_in_use():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not available")


def tf32(a):
    """``a`` rounded to nearest at TF32's 10-bit mantissa (as an f32 GEMM
    at Precision.DEFAULT reads its inputs on the card), back in f64."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32).astype(np.float64)


def _stage_table(model):
    return ", ".join(f"{n} {s:.3f}" for n, s, _ in model.stage_timings.stages)


# ------------------------------------------------------------------ phase a
def phase_build(cfg, card):
    """Cold, warm and traced builds. Returns the warm model and dataset."""
    import jax

    import bench
    from msm_we_tpu.tracing import device_activity_by_stage

    log("[a] build: build_analyze_model(device_pipeline=True), "
        f"{cfg['n_iterations']} iterations x {cfg['n_segments']} segments, "
        f"{cfg['n_atoms']} atoms, PCA to {cfg['n_components']} components, "
        "12 WE bins x 25 clusters; transform and assignment GEMMs at "
        "Precision.HIGHEST")
    t0 = time.perf_counter()
    dataset = bench.synthetic_dataset(cfg)
    log(f"  set-up (seeded dataset generation, host): "
        f"{time.perf_counter() - t0:.3f} s beside {card}, "
        f"{int(dataset.numSegments.sum())} segments")
    for label in ("cold", "warm"):
        wall, model = bench.build(dataset, cfg)
        log(f"  {label} build: {wall:.3f} s end to end on {card}")
        log(f"    stages (s): {_stage_table(model)}")
    log(f"  peak_bytes_in_use: {peak_bytes_in_use()}")
    n_states = 25 * model._bin_mapper.nbins + 2
    log(f"  JtargetSS={model.JtargetSS!r}, pSS: {len(model.pSS)} states, "
        f"sum={float(np.sum(model.pSS))!r}, cleaned states "
        f"{n_states} -> {model.fluxMatrix.shape[0]}, "
        f"PCA {3 * cfg['n_atoms']} -> {model.ndim} components")
    check("JtargetSS finite and positive", model.JtargetSS, "> 0",
          np.isfinite(model.JtargetSS) and model.JtargetSS > 0)
    check("pSS sums to 1", float(np.sum(model.pSS)), "atol 1e-9",
          abs(float(np.sum(model.pSS)) - 1.0) < 1e-9)

    with tempfile.TemporaryDirectory() as trace_dir:
        with jax.profiler.trace(trace_dir):
            bench.build(dataset, cfg)
        paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True)
        activity = device_activity_by_stage(paths[0])
    log("  device programs per stage (traced warm build):")
    for name, act in activity.items():
        mods = act["modules"]
        shown = ", ".join(mods[:4]) + (f", +{len(mods) - 4}" if len(mods) > 4 else "")
        log(f"    {name}: {act['n_ops']} device ops, busy "
            f"{act['busy_s']:.4f} s [{shown}]")
    # PCAModel.transform's device branch is the module jit__project
    transform_stages = [name for name, act in activity.items()
                        if "jit__project" in act["modules"]]
    check("PCA transform (jit__project) ran on the device in stages",
          transform_stages, "non-empty", bool(transform_stages))
    for stage in ("Dimensionality reduction", "Clustering"):
        n_ops = activity.get(stage, {}).get("n_ops", 0)
        check(f"{stage} ran device programs", n_ops, "> 0", n_ops > 0)
    return model, dataset


# ------------------------------------------------------------------ phase b
def _f64_assign(X, seg_bin, C, center_bin, valid):
    """numpy f64 nearest valid same-bin center: (best, score of every
    center) with out-of-bin centers at +inf."""
    X = X.astype(np.float64)
    C = C.astype(np.float64)
    scores = (C * C).sum(1)[None, :] - 2.0 * X @ C.T
    ok = valid[None, :] & (center_bin[None, :] == seg_bin[:, None])
    scores = np.where(ok, scores, np.inf)
    return scores.argmin(1), scores


def compare_assignments(label, X, seg_bin, C, center_bin, valid, got):
    """Agreement of ``got`` with the f64 argmin; every disagreement must be
    a near-tie: its f64 score gap below ASSIGN_GAP_REL (|x|^2 + |c|^2)."""
    best, scores = _f64_assign(X, seg_bin, C, center_bin, valid)
    rows = np.arange(len(X))
    diff = np.flatnonzero(got != best)
    gap = scores[diff, got[diff]] - scores[diff, best[diff]]
    scale = (X[diff].astype(np.float64) ** 2).sum(1) + (
        C[best[diff]].astype(np.float64) ** 2
    ).sum(1)
    worst = float(np.max(gap / np.maximum(scale, 1e-300))) if len(diff) else 0.0
    log(f"  {label}: agreement {1 - len(diff) / len(rows):.6f} "
        f"({len(diff)} of {len(rows)} rows differ)")
    check(f"{label}: largest relative f64 gap of a differing row", worst,
          f"< {ASSIGN_GAP_REL}", worst < ASSIGN_GAP_REL)


def flux_device_vs_host(model, weight_scale=1.0):
    """(device flux, host flux) over the build's iteration window, both
    through ``get_flux_matrix``, on the same assignments: the device
    program that scatters the flux also emits the ids the host bincount
    then uses. Fails unless the weight guard lets the device route run."""
    from msm_we_tpu import fluxmatrix

    feats = model._featurize_all()
    w0 = feats["weights"]
    iters = list(range(2, model.maxIter))
    try:
        feats["weights"] = w0 * weight_scale
        model._device_flux_row_cache = None  # device_flux_lag0 refills it
        model._parent_idx = None  # the combined flux + ids program
        model._force_device_flux = True
        fluxmatrix.get_flux_matrix(model, 0, iters_to_use=iters)
        assert model._device_flux_row_cache is not None, (
            "the device flux route did not run for these weights"
        )
        fm_dev = model.fluxMatrixRaw * len(iters)
        model._force_device_flux = False
        model._flux_prefer_host = True
        fluxmatrix.get_flux_matrix(model, 0, iters_to_use=iters)
        fm_host = model.fluxMatrixRaw * len(iters)
    finally:
        feats["weights"] = w0
        model._force_device_flux = False
        model._flux_prefer_host = False
        model._device_flux_row_cache = None
    return fm_dev, fm_host


def _check_flux(label, fm_dev, fm_host):
    scale = float(np.abs(fm_host).max())
    err = float(np.abs(fm_dev - fm_host).max()) / scale
    log(f"  {label}: {fm_dev.shape[0]} states, largest entry {scale!r}")
    check(f"{label}: max |device - host| / max entry", err,
          f"<= {FLUX_F64_RTOL}", err <= FLUX_F64_RTOL)


def compare_stored_ids(model):
    """b.1: the parent and child ids the build stored (its dtrajs) against
    a numpy f64 argmin over the same features and the cleaned bank, and
    the basis/target rows against their override ids (target wins)."""
    model._ensure_discretized()
    strat = model._strat
    feats = model._featurize_all()
    C, cb, valid = strat.compact_bank()
    masks = model._pc_masks()
    raw_p, raw_c = model._raw_we_bins()
    for side, X, raw, stored in (
        ("parent", feats["parent"], raw_p, model._parent_idx),
        ("child", feats["child"], raw_c, model._child_idx),
    ):
        is_b, is_t = masks[f"basis_{side[0]}"], masks[f"target_{side[0]}"]
        over = is_b | is_t
        want = np.where(is_t, strat.target_cluster_index,
                        strat.basis_cluster_index)
        wrong = int((stored[over] != want[over]).sum())
        check(f"b.1 {side} basis/target rows carry their override ids",
              f"{wrong} of {int(over.sum())} wrong", "0 wrong", wrong == 0)
        free = ~over
        compare_assignments(
            f"b.1 {side} ids stored by the build (GPU f32 HIGHEST vs "
            "numpy f64)",
            np.asarray(X)[free], strat.we_remap[raw[free]], C, cb, valid,
            np.asarray(stored)[free],
        )


def phase_reference(model, dataset, cfg, card):
    """Layered comparison of the warm build with plain references."""
    import jax
    import jax.numpy as jnp

    import bench
    from msm_we_tpu.parallel.sharded import steady_state_from_flux

    log("[b] layered reference")
    fm_clean = np.asarray(model.fluxMatrix, np.float64)
    p_host = np.asarray(model.pSS, np.float64)
    j_host = float(model.JtargetSS)
    ind_basis = np.atleast_1d(model.indBasis)
    ind_target = np.atleast_1d(model.indTargets)

    # b.1 the build's stored assignments vs numpy f64
    compare_stored_ids(model)

    # b.2 device f64 flux vs host f64 bincount, same assignments
    fm_dev, fm_host = flux_device_vs_host(model)
    _check_flux("b.2 flux (device f64 scatter vs host f64 bincount)",
                fm_dev, fm_host)

    # b.3 device steady state vs host f64 tail on the same flux matrix
    n = fm_clean.shape[0]
    _T, p_dev, j_dev, residual = steady_state_from_flux(
        jnp.asarray(fm_clean, jnp.float32),
        jnp.asarray(np.isin(np.arange(n), ind_basis)),
        jnp.asarray(np.isin(np.arange(n), ind_target)),
    )
    p_err = float(np.abs(np.asarray(p_dev, np.float64) - p_host).max())
    j_err = abs(float(j_dev) - j_host) / j_host
    log(f"  b.3 steady state on {n} states (device f32 HIGHEST powering, "
        f"residual {float(residual)!r}; host f64)")
    # What TF32 does: the host f64 tail on the same T rounded to TF32
    lo = copy.copy(model)
    lo.Tmatrix = tf32(model.Tmatrix)
    lo.get_steady_state()
    p_tf32 = float(np.abs(np.asarray(lo.pSS, np.float64) - p_host).max())
    j_tf32 = abs(lo.get_steady_state_target_flux(_set=False) - j_host) / j_host
    log(f"  b.3 host f64 tail with T rounded to TF32: max |pSS - host| "
        f"{p_tf32!r}, |J - host| / J host {j_tf32!r}")
    check("b.3 max |pSS device - host|", p_err, f"<= {SS_P_ATOL}",
          p_err <= SS_P_ATOL)
    check("b.3 |J device - host| / J host", j_err, f"<= {SS_J_RTOL}",
          j_err <= SS_J_RTOL)
    check("b.3 the J limit rejects TF32 rounding of T", j_tf32,
          f"> {SS_J_RTOL}", j_tf32 > SS_J_RTOL)

    # b.4 the whole build on the CPU, reported only: mini-batch k-means
    # can settle on other centers from last-bit GEMM differences
    with jax.default_device(jax.devices("cpu")[0]):
        wall, cpu_model = bench.build(dataset, cfg, device_pipeline=False)
    rel = abs(cpu_model.JtargetSS - j_host) / j_host
    log(f"  b.4 CPU reference build (host CPU beside {card}): {wall:.3f} s, JtargetSS "
        f"{cpu_model.JtargetSS!r} vs GPU {j_host!r}, relative difference "
        f"{rel!r} (reported, not gated)")


# ------------------------------------------------------------------ phase c
def phase_deep_split(model, scale=1e-250):
    log(f"[c] deep-split weights: WE weights x {scale:g}, device f64 flux")
    w = model._featurize_all()["weights"] * scale
    log(f"  smallest nonzero weight {float(w[w > 0].min())!r}; the weight "
        f"guard sends it to the device: {model._device_f64_weights_ok(w)}")
    fm_dev, fm_host = flux_device_vs_host(model, weight_scale=scale)
    _check_flux("c flux (device f64 scatter vs host f64 bincount)",
                fm_dev, fm_host)


# ------------------------------------------------------------------ phase d
def _hot_step_ids(p, precision):
    """Jitted transform + discretize + scatter of the hot step, returning
    the flux matrix and the override-applied (parent, child) ids."""
    import jax
    import jax.numpy as jnp

    from msm_we_tpu.parallel.sharded import _discretize_and_flux

    n_bins = int(p["center_bin"].max()) + 1

    @jax.jit
    def run(raw_parent, raw_child, mean, comp, pbins, cbins, basis_p,
            basis_c, target_c, w, centers, center_bin, valid):
        offset = jnp.matmul(mean, comp, precision=precision)
        fc = jnp.matmul(raw_child, comp, precision=precision) - offset
        fp = jnp.matmul(raw_parent, comp, precision=precision) - offset
        return _discretize_and_flux(
            fp, fc, pbins, cbins, basis_p, basis_c, target_c, w,
            centers, center_bin, valid, p["n_states"], n_bins=n_bins,
            precision=precision,
        )

    return run


def phase_hot_step(p, card, n_trials=20):
    import jax

    import bench

    n, d_raw = p["raw_child"].shape
    log(f"[d] hot step: {n} segments x {d_raw} raw dims -> "
        f"{p['comp'].shape[1]} components x {len(p['centers'])} centers, "
        "GEMMs at Precision.HIGHEST")
    step, args = bench.device_pipeline(p)
    args = tuple(jax.device_put(a) for a in args)
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    log(f"  compile: {time.perf_counter() - t0:.3f} s for {card}")
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    t_min, t_med, (fm, pss, flux, residual) = bench.time_step(
        compiled, args, n_trials=n_trials
    )
    flops, bytes_moved = bench.step_flops_bytes(p)
    log(f"  XLA step time on {card}: min {t_min!r} s, median {t_med!r} s "
        f"over {n_trials} calls ({n / t_min:.6g} frames/s, "
        f"{flops / t_min / 1e12:.4g} TFLOP/s, {bytes_moved / t_min / 1e9:.4g} "
        "GB/s by the bench's FLOP and byte model)")
    check("step outputs finite, pSS sums to 1",
          float(np.asarray(pss).sum()), "atol 1e-4",
          np.isfinite(np.asarray(fm)).all()
          and abs(float(np.asarray(pss).sum()) - 1.0) < 1e-4)

    hi = _hot_step_ids(p, jax.lax.Precision.HIGHEST)
    fm_hi, pidx, cidx = (np.asarray(a) for a in hi(*args))
    # The scatter against a bincount of its own ids: f32 weights, f32 sums
    want = np.bincount(
        pidx.astype(np.int64) * p["n_states"] + cidx,
        weights=p["w"].astype(np.float64), minlength=p["n_states"] ** 2,
    ).reshape(fm_hi.shape)
    err = float(np.abs(fm_hi - want).max() / np.abs(want).max())
    check("flux vs f64 bincount of the same ids (max diff / max entry)",
          err, f"<= {FLUX_F32_RTOL}", err <= FLUX_F32_RTOL)

    # Assignments of rows not overridden to basis/target, vs numpy f64
    mean64 = p["mean"].astype(np.float64)
    comp64 = p["comp"].astype(np.float64)
    free_p = ~p["basis_p"]
    free_c = ~(p["basis_c"] | p["target_c"])
    for label, raw, bins, free, ids in (
        ("parent", p["raw_parent"], p["pbins"], free_p, pidx),
        ("child", p["raw_child"], p["cbins"], free_c, cidx),
    ):
        X = (raw[free].astype(np.float64) - mean64) @ comp64
        compare_assignments(
            f"{label} assignment (GPU f32 HIGHEST vs numpy f64 from raw)",
            X, bins[free], p["centers"], p["center_bin"], p["valid"],
            ids[free],
        )

    lo = _hot_step_ids(p, jax.lax.Precision.DEFAULT)
    _fm, pidx_lo, cidx_lo = (np.asarray(a) for a in lo(*args))
    flips = int((pidx_lo != pidx)[free_p].sum() + (cidx_lo != cidx)[free_c].sum())
    rows = int(free_p.sum() + free_c.sum())
    log(f"  assignments that change at Precision.DEFAULT (TF32 on this "
        f"card) vs HIGHEST: {flips} of {rows} rows = {flips / rows!r}")


# ------------------------------------------------------------------ phase e
def _random_metastable(n, seed=1):
    rng = np.random.default_rng(seed)
    T = rng.random((n, n)) * 0.02 + np.diag(rng.random(n) * 20 + 1)
    return T / T.sum(axis=1, keepdims=True)


def phase_fpt(n_states=FPT_STATES, max_n_lags=50):
    from msm_we_tpu.msm.fpt import MatrixFPT, _DeviceVectorPowers

    log(f"[e] FPT engines at {n_states} states, device in f32 at "
        "Precision.HIGHEST vs host f64")
    T = _random_metastable(n_states)
    ini, fin, w = [0, 1, 2], [n_states - 2, n_states - 1], [0.5, 0.3, 0.2]

    def host_pdf(T):
        return MatrixFPT.fpt_distribution(T, ini, fin, w, max_n_lags=max_n_lags)

    host = host_pdf(T)
    dev = MatrixFPT.fpt_distribution(
        T, ini, fin, w, max_n_lags=max_n_lags, engine="device"
    )
    peak = np.abs(host[:, 1]).max()
    err = float(np.abs(dev[:, 1] - host[:, 1]).max() / peak)
    err_tf32 = float(np.abs(host_pdf(tf32(T))[:, 1] - host[:, 1]).max() / peak)
    log(f"  host f64 fpt_distribution with T rounded to TF32: {err_tf32!r} "
        "of the peak")
    check(f"fpt_distribution ({max_n_lags} lags) max |device - host| / peak",
          err, f"<= {FPT_RTOL}", err <= FPT_RTOL)
    check("the FPT limit rejects TF32 rounding of T", err_tf32,
          f"> {FPT_RTOL}", err_tf32 > FPT_RTOL)

    A = T.copy()
    A[fin, :] = 0.0
    A[fin, fin] = 1.0
    v0 = np.zeros(n_states)
    v0[ini] = w
    powers = _DeviceVectorPowers(A, v0)
    A_tf32 = tf32(A)
    worst = worst_tf32 = 0.0
    for step in (1, 7, 64, 1000, 12345):
        want = v0 @ np.linalg.matrix_power(A, step)
        scale = np.abs(want).max()
        got = np.asarray(powers(step), np.float64)
        worst = max(worst, float(np.abs(got - want).max() / scale))
        got_tf32 = v0 @ np.linalg.matrix_power(A_tf32, step)
        worst_tf32 = max(worst_tf32,
                         float(np.abs(got_tf32 - want).max() / scale))
    log(f"  host f64 vector powers with T rounded to TF32: {worst_tf32!r} "
        "of the max")
    check("vector powers v0 T^s, s up to 12345: max |device - host| / max",
          worst, f"<= {VPOW_RTOL}", worst <= VPOW_RTOL)
    check("the vector-power limit rejects TF32 rounding of T", worst_tf32,
          f"> {VPOW_RTOL}", worst_tf32 > VPOW_RTOL)


# --------------------------------------------------------------- 4 GPUs
def phase_four_gpus(devices, cfg, n_rows=102_400, card="not available"):
    """The ('data', 'model') mesh over four devices against one of them."""
    import bench
    from msm_we_tpu.parallel import make_mesh
    from msm_we_tpu.parallel.sharded import build_sharded_step
    from msm_we_tpu.testing import tiny_stratified_problem

    assert len(devices) == 4, f"needs 4 devices, got {len(devices)}"
    mesh4 = make_mesh(devices, model_parallel=2)
    mesh1 = make_mesh(devices[:1])
    log(f"[4] sharded step on a {dict(mesh4.shape)} mesh vs one device: "
        f"{n_rows} rows, dyadic weights, f32 HIGHEST scores")
    p = tiny_stratified_problem(n_rows=n_rows, d=30, n_bins=10, k=25)
    args = [p[k] for k in ("fp", "fc", "pbins", "cbins", "basis_p", "basis_c",
                           "target_c", "w", "centers", "center_bin", "valid")]
    n_bins = int(p["center_bin"].max()) + 1
    fm4 = np.asarray(build_sharded_step(mesh4, p["n_states"], n_bins=n_bins)(*args))
    fm1 = np.asarray(build_sharded_step(mesh1, p["n_states"], n_bins=n_bins)(*args))
    check("flux matrix bitwise equal", int((fm4 != fm1).sum()),
          "differing entries == 0", np.array_equal(fm4, fm1))

    log(f"[4] build over the {dict(mesh4.shape)} mesh vs one device, "
        f"{cfg['n_iterations']} iterations x {cfg['n_segments']} segments, "
        f"{cfg['n_atoms']} atoms")
    dataset = bench.synthetic_dataset(cfg)
    results = {}
    for label, mesh in (("4 devices", mesh4), ("1 device", mesh1)):
        for run in ("cold", "warm"):
            wall, model = bench.build(dataset, cfg, mesh=mesh)
            log(f"  {label}, {run}: {wall:.3f} s on {card}, JtargetSS "
                f"{model.JtargetSS!r}")
        results[label] = model.JtargetSS
    rel = abs(results["4 devices"] - results["1 device"]) / results["1 device"]
    check("JtargetSS relative difference", rel, f"<= {MESH_J_RTOL}",
          rel <= MESH_J_RTOL)


# ------------------------------------------------------------------- main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU mesh comparisons")
    args = ap.parse_args(argv)

    import logging

    import jax

    import bench
    from msm_we_tpu.utils import enable_compilation_cache

    logging.getLogger("msm_we_tpu").setLevel(logging.WARNING)
    cache = enable_compilation_cache()
    ident = bench.device_identity()
    if ident["platform"] != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{ident['platform']} ({ident['kind']})", file=sys.stderr)
        return 2

    card = bench.card_name_and_power_limit()
    log(f"device: platform={ident['platform']} kind={ident['kind']} "
        f"count={ident['count']} jax={jax.__version__}")
    log(f"compilation cache: {cache or 'JAX default'}")
    optional = []
    for name in ("h5py", "networkx", "rich", "sklearn", "matplotlib"):
        try:
            __import__(name)
            optional.append(f"{name}=yes")
        except ImportError:
            optional.append(f"{name}=no")
    log(f"optional packages: {' '.join(optional)}")

    t0 = time.perf_counter()
    if args.four_gpus:
        if ident["count"] < 4:
            raise SystemExit(f"--four-gpus needs 4 GPUs, found {ident['count']}")
        phase_four_gpus(jax.devices()[:4], bench.BUILD, card=card)
        ident = dict(ident, count=4)
    else:
        model, dataset = phase_build(bench.BUILD, card)
        phase_reference(model, dataset, bench.BUILD, card)
        phase_deep_split(model)
        del model, dataset
        phase_hot_step(bench.make_problem(**HOT_STEP), card)
        phase_fpt()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {card}")
    print(result_line(ident), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
