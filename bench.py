"""Benchmark: the haMSM hot step and the end-to-end build, on one GPU.

Two measurements, both on the default device, which must be a GPU:

1. **Hot step** -- the fused device step (PCA transform -> stratified cluster
   assignment -> weighted flux scatter -> steady state) at realistic shapes:
   raw featurization dim 900 (~300 atoms x 3, NTL9-scale) projected to 30
   components on device, 102,400 WE segments, 250 stratified centers.
   Reports the step time (``block_until_ready`` around each call), frames/s,
   achieved TFLOP/s and the roofline share against the card's peaks.

2. **End-to-end** -- ingest -> featurize -> stratified cluster -> flux ->
   clean -> steady state (``build_analyze_model(device_pipeline=True)``) on
   the ``BUILD`` dataset (101k segments x 900 raw dims, PCA to 30
   components) held in memory. One build compiles; the warm builds'
   wall-clock and per-stage medians are reported.

Prints the device identity and the card's name and power limit on stderr,
then ONE JSON line on stdout. Exits non-zero when the default device is
not a GPU: there is no CPU fallback.
"""
import json
import logging
import subprocess
import sys
import time

import numpy as np

# The package logger defaults to INFO (stage reports etc., via a RichHandler
# that writes to stdout); the bench's contract is ONE JSON line on stdout
logging.getLogger("msm_we_tpu").setLevel(logging.ERROR)

# (f32 FLOP/s outside the tensor cores, HBM bytes/s) by jax device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: 67 TFLOP/s
# FP32 (what Precision.HIGHEST f32 GEMMs run on) and 3.35 TB/s HBM3. The
# rates assume the card's full 700 W power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def device_peaks(device_kind):
    """(peak_flops, hbm_bytes_per_s) of ``device_kind``; an unknown device
    is an error, not a default."""
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"No peak rates on record for device kind {device_kind!r}; add "
            "them to DEVICE_PEAKS with their source."
        ) from None


def device_identity():
    """{"platform", "kind", "count"} of the default devices as JAX reports
    them."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_name_and_power_limit():
    """The card's name and power limit as ``nvidia-smi`` reports them, read
    from a child process that never touches JAX (so it takes no share of
    the card); "not available" without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({type(e).__name__})"
    return out.splitlines()[0] if out else "not available"


def make_problem(n_segments=102_400, n_raw_features=900, n_components=30,
                 n_bins=10, k_per_bin=25, seed=0, fallback_frac=0.02):
    """Synthesize an NTL9-scale stratified-assignment problem.

    Raw features are ~300 atoms x 3 coords; the PCA projection runs on
    device, so the GEMM is the real (N, 900) @ (900, 30) transform.

    Parent coordinates carry WE's trajectory-continuity structure: each
    segment's parent frame is a bit-copy of another segment's child frame
    (``parent_rows``), except a ``fallback_frac`` recycled fraction
    (``parent_rows == -1``) with independent basis-region frames
    (``raw_fallback``). The dedup step variant exploits this; the
    two-transform step ignores it (both see identical raw arrays).
    """
    rng = np.random.default_rng(seed)
    n_fb = max(int(n_segments * fallback_frac), 1)
    parent_rows = rng.permutation(n_segments).astype(np.int32)
    fb_idx = np.sort(rng.choice(n_segments, n_fb, replace=False)).astype(np.int32)

    pc_child = 10 * rng.beta(0.7, 0.7, n_segments)
    pc_parent = pc_child[parent_rows].copy()
    pc_parent[fb_idx] = 9.0 + rng.random(n_fb)  # recycled: basis region
    parent_rows[fb_idx] = -1

    def embed(pc):
        base = np.outer(pc, rng.normal(1, 0.2, n_raw_features) * 0.3)
        return (base + rng.normal(0, 0.3, base.shape)).astype(np.float32)

    raw_child = embed(pc_child)
    raw_fallback = embed(pc_parent[fb_idx])
    raw_parent = raw_child[np.where(parent_rows < 0, 0, parent_rows)].copy()
    raw_parent[fb_idx] = raw_fallback

    # PCA transform fitted on a subsample (host, not timed)
    sub = raw_child[:: max(1, n_segments // 4096)]
    mean = sub.mean(0)
    cov = np.cov((sub - mean).T)
    evals, evecs = np.linalg.eigh(cov)
    comp = evecs[:, np.argsort(evals)[::-1][:n_components]].astype(np.float32)

    edges = np.linspace(0, 10, n_bins + 1)
    pbins = np.clip(np.digitize(pc_parent, edges) - 1, 0, n_bins - 1).astype(np.int32)
    cbins = np.clip(np.digitize(pc_child, edges) - 1, 0, n_bins - 1).astype(np.int32)

    # Stratified centers: fit per bin on a subsample (host, not timed)
    feats_sub = (sub - mean) @ comp
    K = n_bins * k_per_bin
    centers = np.zeros((K, n_components), np.float32)
    sub_pc = pc_child[:: max(1, n_segments // 4096)]
    sub_bins = np.clip(np.digitize(sub_pc, edges) - 1, 0, n_bins - 1)
    for b in range(n_bins):
        members = feats_sub[sub_bins == b]
        if len(members) >= k_per_bin:
            idx = rng.choice(len(members), k_per_bin, replace=False)
            centers[b * k_per_bin : (b + 1) * k_per_bin] = members[idx]
        else:
            centers[b * k_per_bin : (b + 1) * k_per_bin] = rng.normal(
                0, 1, (k_per_bin, n_components)
            )

    weights = np.exp(rng.uniform(np.log(1e-12), 0, n_segments))
    weights /= weights.sum()

    return dict(
        raw_parent=raw_parent, raw_child=raw_child,
        parent_rows=parent_rows, fb_idx=fb_idx, raw_fallback=raw_fallback,
        mean=mean.astype(np.float32), comp=comp,
        pbins=pbins, cbins=cbins,
        basis_p=(pc_parent > 9.0), basis_c=(pc_child > 9.0),
        target_c=(pc_child < 1.0),
        w=weights.astype(np.float32),
        centers=centers,
        center_bin=np.repeat(np.arange(n_bins, dtype=np.int32), k_per_bin),
        valid=np.ones(K, bool),
        n_states=K + 2,
    )


def step_flops_bytes(p, ss_iters=512, dedup=False):
    """Matmul FLOPs and minimum HBM traffic of one fused step."""
    import math

    N, Draw = p["raw_child"].shape
    n_fb = len(p["fb_idx"])
    Dc = p["comp"].shape[1]
    K = len(p["centers"])
    S = p["n_states"]
    n_transformed = (N + n_fb) if dedup else 2 * N
    # Steady state runs by repeated matrix squaring: ceil(log2(ss_iters))
    # (S, S) @ (S, S) matmuls (steady_state_from_flux)
    squarings = max(math.ceil(math.log2(max(ss_iters, 2))), 1)
    flops = (
        2.0 * n_transformed * Draw * Dc  # PCA transforms
        + 2 * (2.0 * N * Dc * K)       # parent+child distance matmuls
        + squarings * 2.0 * S**3       # steady-state matrix squarings
    )
    bytes_moved = (
        n_transformed * Draw * 4       # raw coords read (dominant)
        + 2 * (2 * N * Dc * 4)         # feature write + read
        + 2 * N * K * 4                # distance matrices write (argmin fused read)
        + N * (4 * 4)                  # bins/masks/weights
    )
    if dedup:
        # One extended feature array instead of two: write + child-assign
        # read + gather read feeding the parent GEMM (the minimum, with the
        # gather fused into the GEMM input) = 3 N*Dc transfers vs the
        # two-array path's 4. Understates rather than inflates sol_fraction.
        bytes_moved -= N * Dc * 4
    return flops, bytes_moved


def device_pipeline(p, fast_math=False, dedup=False):
    """Jitted transform + stratified assign + flux + steady state.

    ``dedup=True`` exploits WE trajectory continuity (the production
    ``dedup_coordinates`` path): parent features are a row-gather of the
    child features at ``parent_rows``, so only ONE (N, 900) raw array is
    read and transformed per step instead of two. Recycled rows' fallback
    frames are concatenated onto the raw array host-side and addressed by
    extended gather indices. Identical flux matrix.

    ``fast_math=True`` runs the GEMMs at default precision (TF32 on the
    GPU) instead of ``Precision.HIGHEST``; assignments may flip on
    near-ties.
    """
    import jax
    import jax.numpy as jnp

    from msm_we_tpu.parallel.sharded import (
        _discretize_and_flux,
        steady_state_from_flux,
    )

    n_states = p["n_states"]
    n_bins = int(p["center_bin"].max()) + 1

    @jax.jit
    def step(raw_parent, raw_child, mean, comp, pbins, cbins,
             basis_p, basis_c, target_c, w,
             centers, center_bin, valid,
             parent_rows=None):
        # Centering folded into a bias: (x - mu) @ C == x @ C - mu @ C,
        # which saves an elementwise pass over the raw matrix. The bias
        # GEMM runs at the step's precision too: a TF32 offset would shift
        # every feature by its rounding error.
        prec = "default" if fast_math else jax.lax.Precision.HIGHEST
        offset = jnp.matmul(mean, comp, precision=prec)
        if dedup:
            # raw_child is [child rows; fallback rows] (N + n_fb, 900);
            # parent_rows already point into the extended feature array
            fc_ext = jnp.matmul(raw_child, comp, precision=prec) - offset[None, :]
            fc = fc_ext[: len(pbins)]
            fp = fc_ext[parent_rows]
        else:
            fc = jnp.matmul(raw_child, comp, precision=prec) - offset[None, :]
            fp = jnp.matmul(raw_parent, comp, precision=prec) - offset[None, :]
        fm, _pi, _ci = _discretize_and_flux(
            fp, fc, pbins, cbins, basis_p, basis_c, target_c, w,
            centers, center_bin, valid, n_states, n_bins=n_bins,
            precision=prec,
        )
        basis_mask = jnp.arange(n_states) == n_states - 2
        target_mask = jnp.arange(n_states) == n_states - 1
        _T, pss, flux, residual = steady_state_from_flux(fm, basis_mask, target_mask)
        return fm, pss, flux, residual

    args = (
        p["raw_parent"], p["raw_child"], p["mean"], p["comp"],
        p["pbins"], p["cbins"], p["basis_p"], p["basis_c"], p["target_c"],
        p["w"], p["centers"], p["center_bin"], p["valid"],
    )
    if dedup:
        # The full raw_parent array is not an input at all in this tier.
        # Fallback frames ride as extra rows of the raw array; recycled
        # parents gather from them via extended indices.
        n = len(p["raw_child"])
        rows_ext = p["parent_rows"].copy()
        rows_ext[p["fb_idx"]] = n + np.arange(len(p["fb_idx"]), dtype=np.int32)
        raw_ext = np.concatenate([p["raw_child"], p["raw_fallback"]])
        args = (
            (np.zeros((1, 1), np.float32), raw_ext) + args[2:] + (rows_ext,)
        )
    return step, args


def time_step(step, args, n_trials=20):
    """(min, median) seconds of one step, ``block_until_ready`` around each
    call, after one warm-up call that compiles; and the last outputs."""
    import jax

    out = jax.block_until_ready(step(*args))
    times = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        out = jax.block_until_ready(step(*args))
        times.append(time.perf_counter() - t0)
    return min(times), float(np.median(times)), out


# The end-to-end build at NTL9 width: the reference's regression set
# (tests/fixtures/hamsms.py:63-72: 100 iterations, 25 clusters per WE bin,
# ~300 atoms = 900 raw dims), PCA keeping 30 components. The synthetic
# coordinates carry 2 degrees of freedom, so a variance cutoff would keep 2
# components; 30 is the width of the hot step below.
BUILD = dict(n_iterations=101, n_segments=1000, n_atoms=300, n_components=30,
             seed=17)


def synthetic_dataset(cfg):
    """In-memory synthetic WE dataset of ``cfg`` (keys as ``BUILD``) with
    ``n_iterations`` usable iterations (one more, incomplete, is generated
    as in a west.h5)."""
    from msm_we_tpu.data import (
        SynthWESettings, WEDataset, generate_trajectory_arrays,
    )

    settings = SynthWESettings(
        n_iterations=cfg["n_iterations"] + 1, n_segments=cfg["n_segments"],
        n_atoms=cfg["n_atoms"], warmup=20, seed=cfg["seed"],
    )
    return WEDataset.from_arrays(generate_trajectory_arrays(settings))


def build(dataset, cfg, device_pipeline=True, mesh=None):
    """``build_analyze_model`` on ``dataset`` as ``cfg`` (keys as ``BUILD``)
    sets it: PCA to ``n_components``, 12 rectilinear WE bins over [0, 10],
    25 clusters per bin, the streaming fill loop as one device scan.
    ``mesh`` replaces the default mesh over every visible device. Returns
    (wall seconds, model)."""
    from msm_we_tpu.binning import RectilinearBinMapper
    from msm_we_tpu.model import modelWE

    mapper = RectilinearBinMapper([np.linspace(0, 10, 13)])
    model = modelWE()
    if mesh is not None:
        model.enable_mesh(mesh)
    t0 = time.perf_counter()
    model.build_analyze_model(
        file_paths=dataset,
        ref_struct={"coords": None, "nAtoms": cfg["n_atoms"], "coord_ndim": 3},
        modelName="bench",
        basis_pcoord_bounds=[[9.0, 10.0]],
        target_pcoord_bounds=[[0.0, 1.0]],
        dimreduce_method="pca",
        tau=1.0,
        n_clusters=25,
        cross_validation_groups=0,
        show_live_display=False,
        device_pipeline=device_pipeline,
        step_kwargs={
            "dimReduce": {"n_components": cfg["n_components"]},
            "clustering": {
                "user_bin_mapper": mapper,
                "scan_small_batches": True,
            },
        },
    )
    return time.perf_counter() - t0, model


def run_end_to_end(cfg=BUILD, n_warm=5):
    """One compiling build, then ``n_warm`` warm builds of ``cfg``'s
    dataset. Returns (summary, JtargetSS of the first warm build)."""
    t0 = time.perf_counter()
    dataset = synthetic_dataset(cfg)
    setup_s = time.perf_counter() - t0
    build(dataset, cfg)  # compiles
    runs = [build(dataset, cfg) for _ in range(n_warm)]
    times = sorted(t for t, _m in runs)
    stage_samples = {}
    for _t, m in runs:
        for name, secs, _note in m.stage_timings.stages:
            stage_samples.setdefault(name, []).append(secs)
    summary = {
        "end_to_end_dataset_setup_s": setup_s,
        "end_to_end_s": times[0],
        "end_to_end_median_s": float(np.median(times)),
        "end_to_end_max_s": times[-1],
        "end_to_end_n_warm": n_warm,
        "end_to_end_stages_median": {
            name: float(np.median(v)) for name, v in stage_samples.items()
        },
    }
    return summary, float(runs[0][1].JtargetSS)


def main():
    import jax

    from msm_we_tpu.utils import enable_compilation_cache

    ident = device_identity()
    if ident["platform"] != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX's default device is {ident['platform']} "
            f"({ident['kind']})"
        )
    card = card_name_and_power_limit()
    print(f"device: {ident} jax {jax.__version__}", file=sys.stderr)
    print(f"card: {card}", file=sys.stderr, flush=True)
    enable_compilation_cache()
    peak_flops, peak_bw = device_peaks(ident["kind"])

    p = make_problem()
    n_segments = len(p["raw_parent"])
    step, args = device_pipeline(p)
    args = tuple(jax.device_put(a) for a in args)
    t_min, t_med, (fm, _pss, flux, ss_residual) = time_step(step, args)

    # Tiers reuse the device-resident shared inputs: a second device_put
    # would duplicate ~740 MB of raw coordinates on the device
    step_fast, _ = device_pipeline(p, fast_math=True)
    t_fast, _t, _out = time_step(step_fast, args)
    step_dd, args_dd = device_pipeline(p, dedup=True)
    args_dd = (
        (jax.device_put(args_dd[0]), jax.device_put(args_dd[1]))
        + args[2:13]
        + (jax.device_put(args_dd[13]),)
    )
    t_dedup, _t, (fm_d, *_rest) = time_step(step_dd, args_dd)
    dedup_max_diff = float(
        np.max(np.abs(np.asarray(fm_d) - np.asarray(fm)))
        / max(float(np.max(np.abs(np.asarray(fm)))), 1e-30)
    )

    flops, bytes_moved = step_flops_bytes(p)
    sol_time = max(flops / peak_flops, bytes_moved / peak_bw)
    flops_dd, bytes_dd = step_flops_bytes(p, dedup=True)

    e2e, j_e2e = run_end_to_end()

    result = {
        "metric": "PCA-transform + stratified-assign + fluxmatrix + steady-state step time",
        "value": t_min,
        "unit": "s",
        "device": ident,
        "card": card,
        "step_time_median_s": t_med,
        "frames_per_sec": n_segments / t_min,
        "n_segments": n_segments,
        "raw_dim": int(p["raw_parent"].shape[1]),
        "n_components": int(p["comp"].shape[1]),
        "n_states": p["n_states"],
        "step_time_fast_math_s": t_fast,
        "step_time_dedup_s": t_dedup,
        "dedup_flux_max_rel_diff": dedup_max_diff,
        "achieved_tflops": flops / t_min / 1e12,
        "roofline_share": sol_time / t_min,
        "roofline_bound": (
            "hbm" if bytes_moved / peak_bw > flops / peak_flops else "f32 flops"
        ),
        "roofline_share_dedup": (
            max(flops_dd / peak_flops, bytes_dd / peak_bw) / t_dedup
        ),
        **e2e,
        "end_to_end_JtargetSS": j_e2e,
        "JtargetSS": float(flux),
        "ss_residual": float(ss_residual),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
