"""Flux-matrix estimation engine: host f64 bincount path, the fused
mesh-sharded device path, and the routing between them.

Extracted from the ``modelWE`` facade (which delegates here unchanged).
Capability parity with the reference's ``get_fluxMatrix``
(``msm_we/_hamsm/_fluxmatrix.py:166-345``), redesigned per SURVEY.md
section 7: one vectorized scatter-add over all selected transitions instead
of a Ray fan-out over iterations, with an optional shard_map program
(discretize -> f64 scatter -> psum) when a device mesh is enabled.
"""
from __future__ import annotations

import os

import numpy as np

from functools import lru_cache

from ._logging import log
from .features import _id_columns_to_host, _pad_rows_to


@lru_cache(maxsize=16)
def _remap_gather_fn(sharding):
    """Jitted on-device WE-bin remap gather (memoized per sharding).

    The raw per-segment WE bins are call-invariant (cached on device with
    the other row arrays), while ``strat.we_remap`` is a handful of ints
    that changes when cleaning empties a bin -- re-uploading 2N remapped
    int32 bins would move O(N) bytes per flux call; uploading the tiny
    remap and gathering on device moves a few ints. Padded rows (-1) stay
    -1."""
    import jax
    import jax.numpy as jnp

    def f(raw, remap):
        return jnp.where(
            raw >= 0, remap[jnp.maximum(raw, 0)], jnp.int32(-1)
        ).astype(jnp.int32)

    return jax.jit(f, out_shardings=sharding)


def get_flux_matrix(
    model,
    n_lag,
    first_iter=1,
    last_iter=None,
    iters_to_use=None,
    use_ray=False,
    result_batch_size=5,
    progress_bar=None,
):
    """Weighted flux matrix over iterations (reference ``get_fluxMatrix``,
    ``_fluxmatrix.py:166-345``): one vectorized scatter-add over all
    selected transitions, normalized by the number of iterations used.

    WE weights span many orders of magnitude, so the final (n+2)^2
    accumulation runs in float64 on the host (a trivial bincount); the
    expensive part -- discretization -- already ran on device. With a
    mesh enabled, the fused device path (parallel.sharded: f32 assign +
    f64 scatter + psum) replaces this host accumulation entirely.

    ``n_lag > 0`` builds (n_lag+1)-tau transitions: the start state is the
    *ancestor's* frame-0 assignment ``n_lag`` iterations back (already
    discretized -- lagged starts reuse the parent-feature assignments, no
    new device work), with recycled-within-window lineages departing from
    the basis state. Extends the reference, whose lag machinery is gated
    (``msm_we.py:353-359``).
    """
    model._fluxMatrixParams = [n_lag, first_iter, last_iter, iters_to_use]

    if iters_to_use is None:
        if last_iter is None:
            last_iter = model.maxIter
        iters_to_use = range(max(first_iter + 1, n_lag + 1), last_iter)
    in_range = [i for i in iters_to_use if i - n_lag >= 1 and i < model.maxIter]
    if len(in_range) != len(iters_to_use):
        dropped = sorted(set(iters_to_use) - set(in_range))
        log.warning(
            f"Dropping iterations {dropped} from the flux matrix: outside "
            f"the usable range [{n_lag + 1}, {model.maxIter - 1}] at "
            f"n_lag={n_lag}"
        )
    iters_to_use = in_range
    if not iters_to_use:
        raise ValueError(
            f"No iterations have enough history for n_lag={n_lag} "
            f"(first_iter={first_iter}, last_iter={last_iter})"
        )

    model.n_lag = n_lag
    model.errorWeight = 0.0
    model.errorCount = 0

    feats = model._featurize_all()
    n_states = model.n_clusters + 2

    use_device_flux = (
        n_lag == 0
        and model._mesh is not None
        and model.clusters is not None
        and not getattr(model, "_flux_prefer_host", False)
        and model._device_f64_weights_ok(feats["weights"])
    )
    if use_device_flux and not getattr(model, "_force_device_flux", False):
        # Single-process meshes: the predict ids land on the host either
        # way (deferred discretization runs ONE ids-only sharded program;
        # otherwise they are already stored), and the host f64 bincount
        # below then replaces the device flux program. Cleaning recomputes
        # the flux 2-3x per build, and each host pass reuses the ids.
        #
        # A device-resident big-N route exists behind
        # MSM_WE_TPU_DEVICE_FLUX_MIN_ROWS but is disabled by default (10**18
        # rows). That default is still to be measured on the GPU
        # (ROADMAP). The knob also serves multi-process meshes (no global
        # ids on one host).
        import jax

        n_rows = int(feats["offsets"][-1])
        big = n_rows >= int(
            os.environ.get("MSM_WE_TPU_DEVICE_FLUX_MIN_ROWS",
                           str(10**18))
        )
        if jax.process_count() == 1 and (
            model._parent_idx is not None or not big
        ):
            model._ensure_discretized()
            use_device_flux = False
    if use_device_flux:
        # Fused shard_map program (discretize -> f64 scatter -> psum)
        # over the mesh. Works for stratified (per-bin bank) and
        # aggregated (single-bin bank) clustering alike.
        model.fluxMatrixRaw = model._device_flux_lag0(iters_to_use) / len(
            iters_to_use
        )
        return

    # Deferred discretization (the device fast path above normally
    # materializes ids as a flux byproduct): any host-path build --
    # lag>0, device fallback, or a user bypassing the mesh -- needs the
    # stored ids, so materialize them now
    model._ensure_discretized()

    if n_lag == 0:
        n_iters_all = len(feats["offsets"]) - 1
        u = np.unique(iters_to_use)
        contiguous = (
            len(u) == len(iters_to_use)  # no duplicates
            and u[-1] - u[0] + 1 == len(u)  # gap-free range
            and u[0] >= 1
            and u[-1] <= n_iters_all
        )
        if contiguous:
            # Feature rows are ordered by iteration, so ANY contiguous
            # iteration range -- the default window range(2, maxIter),
            # every cleaning pass, and explicit first/last selections --
            # is a contiguous row slice: skip the O(N) isin scan and let
            # basic slicing replace the row gathers. (The old predicate
            # demanded ALL iterations starting at 1, which the default
            # window never satisfies, leaving this path dead.)
            offs = feats["offsets"]
            sel = slice(int(offs[u[0] - 1]), int(offs[u[-1]]))
        else:
            # Integer rows, not a boolean mask: 2-D boolean indexing
            # takes a slow numpy path on this host (~2x the int gather
            # at 2M rows)
            sel = np.flatnonzero(np.isin(feats["iteration"], iters_to_use))
        weights = feats["weights"][sel]
        masks = model._pc_masks()
        start_idx = np.asarray(model._parent_idx[sel], dtype=np.int64)
        end_idx = np.asarray(model._child_idx[sel], dtype=np.int64)
        strat = model._strat
        if (
            model.clustering_method == "stratified"
            and strat is not None
            and model.n_clusters == strat.n_total_clusters
        ):
            # Fast path (every cleaning pass): stored stratified dtrajs
            # already carry the predict-time basis/target overrides
            # (target wins overlaps, stratified_clustering.py:159-169)
            # in the CURRENT numbering; the flux build's basis-wins
            # composition (_fluxmatrix.py:134-137) differs only on rows
            # inside BOTH regions. Bitwise-identical to the general
            # chain below, minus ~6 O(N) passes per pass. Pre-cleaning
            # (nominal n_clusters > live total) the stored basis/target
            # ids use the live total, so the general chain re-applies
            # them with the nominal index instead.
            if masks["overlap_p"] is not None:
                start_idx = start_idx.copy()
                start_idx[masks["overlap_p"][sel]] = model.n_clusters
            if masks["overlap_c"] is not None:
                end_idx = end_idx.copy()
                end_idx[masks["overlap_c"][sel]] = model.n_clusters
        else:
            # General chain: aggregated clustering stores raw
            # (un-overridden) ids, and pre-cleaning stratified ids
            # carry live-total basis/target states -- re-apply the
            # flux-order overrides at the nominal numbering
            # (end-in-target, start-in-target for stratified, then
            # basis unconditionally)
            end_idx = np.where(
                masks["target_c"][sel], model.n_clusters + 1, end_idx
            )
            if model.clustering_method == "stratified":
                start_idx = np.where(
                    masks["target_p"][sel], model.n_clusters + 1, start_idx
                )
            start_idx = np.where(
                masks["basis_p"][sel], model.n_clusters, start_idx
            )
            end_idx = np.where(
                masks["basis_c"][sel], model.n_clusters, end_idx
            )
    else:
        offsets = feats["offsets"]
        masks = model._pc_masks()
        starts, ends, ws, b0s, t0s, b1s, t1s, warps = (
            [], [], [], [], [], [], [], []
        )
        for it in iters_to_use:
            anc, warped = model._dataset.ancestor_ids(it, n_lag)
            rows_now = np.arange(offsets[it - 1], offsets[it])
            rows_lag = offsets[it - n_lag - 1] + np.where(warped, 0, anc)
            starts.append(model._parent_idx[rows_lag])
            ends.append(model._child_idx[rows_now])
            # A zeroed ancestor weight marks bad (NaN) augmentation
            # coords at the lagged frame (westh5 convention); those
            # transitions carry no flux at lag L either -- the start
            # assignment would come from zero-filled garbage features
            w_now = feats["weights"][rows_now].copy()
            w_now[(feats["weights"][rows_lag] == 0.0) & ~warped] = 0.0
            ws.append(w_now)
            b0s.append(masks["basis_p"][rows_lag])
            t0s.append(masks["target_p"][rows_lag])
            b1s.append(masks["basis_c"][rows_now])
            t1s.append(masks["target_c"][rows_now])
            warps.append(warped)
        start_idx = np.concatenate(starts).astype(np.int64)
        end_idx = np.concatenate(ends).astype(np.int64)
        weights = np.concatenate(ws)
        warped_all = np.concatenate(warps)
        # Recycled lineages depart from the basis state regardless of
        # the (meaningless) ancestor pcoord gathered at the safe index
        basis_start = np.concatenate(b0s) | warped_all
        target_start = np.concatenate(t0s) & ~warped_all
        basis_end = np.concatenate(b1s)
        target_end = np.concatenate(t1s)

        # Basis/target overrides, reference composition: predict routes
        # target-region rows to the target cluster first
        # (stratified_clustering.py:159-169) -- re-applied here with the
        # *nominal* target index so the numbering agrees with the fused
        # device kernel pre-cleaning -- and the flux build then applies
        # start/end-in-basis unconditionally AFTER end-in-target
        # (_fluxmatrix.py:134-137). So for rows inside BOTH regions
        # (overlapping bounds), basis wins, for parents and children
        # alike. (The lag-0 branches above compose the same order.)
        end_idx = np.where(target_end, model.n_clusters + 1, end_idx)
        if model.clustering_method == "stratified":
            start_idx = np.where(
                target_start, model.n_clusters + 1, start_idx
            )
        start_idx = np.where(basis_start, model.n_clusters, start_idx)
        end_idx = np.where(basis_end, model.n_clusters, end_idx)

    flat = start_idx * n_states + end_idx
    fm = np.bincount(
        flat, weights=weights, minlength=n_states * n_states
    ).reshape(n_states, n_states)
    model.fluxMatrixRaw = fm / len(iters_to_use)


def _f32_flux_tier():
    """True when ``MSM_WE_TPU_DEVICE_FLUX_F32=1`` opts the device flux
    accumulation into f32."""
    return os.environ.get("MSM_WE_TPU_DEVICE_FLUX_F32", "") == "1"


def device_f64_weights_ok(model, weights):
    """True when the device flux route can accumulate these WE weights
    without losing any.

    The default accumulation is f64, native on CPU and GPU, and takes any
    weight. The opt-in f32 tier (``MSM_WE_TPU_DEVICE_FLUX_F32=1``) keeps
    only f32's exponent range on every platform: weights below ~1.2e-38
    would flush to zero. WE weights legitimately span hundreds of orders of
    magnitude, so such runs take the host f64 bincount path instead, with a
    warning."""
    if not _f32_flux_tier():
        return True
    w = weights[weights != 0]
    if w.size == 0:
        return True
    lo, hi = float(w.min()), float(w.max())
    f32 = np.finfo(np.float32)
    if lo >= float(f32.tiny) and hi <= float(f32.max):
        return True
    log.warning(
        f"WE weights span [{lo:.3g}, {hi:.3g}], outside the f32 exponent "
        "range of the MSM_WE_TPU_DEVICE_FLUX_F32 tier; using the host f64 "
        "flux path for this build (device discretization is unaffected)."
    )
    return False


def device_flux_lag0(model, iters_to_use):
    """Fused mesh-sharded flux matrix: discretize + f64 scatter + psum.

    One shard_map program over the ('data', 'model') mesh -- segments
    data-parallel, the stratified center bank tensor-parallel -- with the
    flux accumulated and psum-reduced in float64 while the distance
    matmuls stay f32 (``jax.enable_x64`` scopes the trace). This replaces
    the reference's Ray gather + driver-side f64 summation
    (``_fluxmatrix.py:311-342``), reachable from ``build_analyze_model``
    via ``enable_mesh``/``device_pipeline``.

    Results match the host bincount path to f64 summation-order (the
    parity test asserts JtargetSS equality through the full build).

    ``MSM_WE_TPU_DEVICE_FLUX_F32=1`` opts the accumulation into plain f32
    (the scatter dtype follows the weights). The tier gives up f32's
    exponent range, which ``device_f64_weights_ok`` guards, and summation
    precision (~1e-6 relative at 10M adds vs ~1e-14). Never the default;
    its speed on the GPU is not measured.
    """
    from .parallel.sharded import build_sharded_step
    from .utils import _scoped_x64

    feats = model._featurize_all()
    strat = model._strat
    mesh = model._mesh

    f32_tier = _f32_flux_tier()
    if f32_tier:
        from contextlib import nullcontext as _scoped_x64  # noqa: F811

    masks = model._pc_masks()
    basis_p = masks["basis_p"]
    # Target-region parents route to the target state only for
    # stratified clustering (the reference's predict-time short-circuit;
    # its aggregated path leaves such parents at their raw cluster)
    if strat is not None:
        target_p = masks["target_p"]
    else:
        target_p = np.zeros(len(feats["weights"]), bool)
    basis_c = masks["basis_c"]
    target_c = masks["target_c"]

    n_states = model.n_clusters + 2
    data_size = mesh.shape["data"]
    model_size = mesh.shape["model"]
    N = len(feats["weights"])

    if strat is not None:
        raw_pbins, raw_cbins = model._raw_we_bins()
        remap = strat.we_remap
        pbins = remap[raw_pbins].astype(np.int32)
        cbins = remap[raw_cbins].astype(np.int32)
        K = strat.n_total_clusters
        n_bins = strat.n_bins
        bank = lambda K_pad: strat.compact_bank(pad_to=K_pad)
    else:
        # Aggregated clustering: one implicit bin holding every center
        centers_all = np.asarray(model.clusters.cluster_centers_, np.float32)
        pbins = np.zeros(N, np.int32)
        cbins = np.zeros(N, np.int32)
        K = len(centers_all)
        n_bins = 1

        def bank(K_pad):
            c = np.zeros((K_pad, centers_all.shape[1]), np.float32)
            cb = np.full(K_pad, -2, np.int32)
            v = np.zeros(K_pad, bool)
            c[:K] = centers_all
            cb[:K] = 0
            v[:K] = True
            return c, cb, v

    N_pad = -(-N // data_size) * data_size
    K_pad = -(-K // model_size) * model_size

    pad_rows = lambda a, fill: _pad_rows_to(a, N_pad, fill)

    # Padded rows carry weight 0 (their scatter adds nothing) and bin -1
    # (matches no center); the compact bank (argmin row == global id,
    # no device gather) pads with invalid rows
    fp_dev, fc_dev = model._device_row_feats()
    centersC, center_binC, validC = bank(K_pad)

    # Call-invariant row arrays (masks, selection-folded f64 weights,
    # RAW WE bins) are uploaded ONCE per (feature set, iteration window,
    # N_pad) and reused across cleaning passes: re-uploading them moves
    # ~100 MB PER get_fluxMatrix call on a 10M build. The REMAPPED bins are derived per call on device from
    # the cached raw bins and the (tiny) current we_remap.
    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as _P

    row_sh = NamedSharding(mesh, _P("data"))
    wkey = (N_pad, tuple(iters_to_use), f32_tier)
    cache = getattr(model, "_device_flux_row_cache", None)
    if cache is None or cache[0] is not feats or cache[1] != wkey:
        # Iteration selection folds into the weights (w * mask; f64 adds
        # of zero are exact), so the big feature arrays need no
        # sel-gather and the device copies cached by _device_row_feats
        # (shared with the sharded discretization) are reused as-is.
        # Computed only on cache miss: the isin+where over all rows is
        # ~0.3-1 s of host work at 10M that a cache hit makes pointless.
        sel = np.isin(feats["iteration"], list(iters_to_use))
        w = np.where(sel, feats["weights"], 0.0).astype(
            np.float32 if f32_tier else np.float64
        )
        with _scoped_x64():
            # Inside the x64 scope: device_put of float64 outside it
            # silently downcasts to f32, defeating the f64 accumulation
            # contract the program traces under
            w_dev = _jax.device_put(pad_rows(w, 0.0), row_sh)
        cache = (
            feats,
            wkey,
            {
                "w": w_dev,
                "basis_p": _jax.device_put(pad_rows(basis_p, False), row_sh),
                "basis_c": _jax.device_put(pad_rows(basis_c, False), row_sh),
                "target_c": _jax.device_put(pad_rows(target_c, False), row_sh),
                "target_p": _jax.device_put(pad_rows(target_p, False), row_sh),
                "raw_p": (
                    _jax.device_put(
                        pad_rows(raw_pbins.astype(np.int32), -1), row_sh
                    )
                    if strat is not None else None
                ),
                "raw_c": (
                    _jax.device_put(
                        pad_rows(raw_cbins.astype(np.int32), -1), row_sh
                    )
                    if strat is not None else None
                ),
            },
        )
        model._device_flux_row_cache = cache
    rows = cache[2]
    if strat is not None and rows.get("raw_p") is not None:
        gather = _remap_gather_fn(row_sh)
        remap_dev = _jax.device_put(strat.we_remap.astype(np.int32))
        pbins_arg = gather(rows["raw_p"], remap_dev)
        cbins_arg = gather(rows["raw_c"], remap_dev)
    else:
        pbins_arg = pad_rows(pbins, -1)
        cbins_arg = pad_rows(cbins, -1)
    args = (
        fp_dev,
        fc_dev,
        pbins_arg,
        cbins_arg,
        rows["basis_p"],
        rows["basis_c"],
        rows["target_c"],
        rows["w"],
        centersC,
        center_binC,
        validC,
        rows["target_p"],
    )

    # build_sharded_step is memoized on (mesh, n_states, ...), so a
    # model-level cache would only risk staleness when enable_mesh()
    # swaps meshes mid-life.
    #
    # Deferred discretization (cluster_stratified(defer_discretization=
    # True)): dtrajs don't exist yet, so run the combined program that
    # emits the packed flux AND the predict-order ids in ONE
    # dispatch+sync -- the two score GEMMs run once for both outputs.
    # EXCEPT at big single-process row counts: there the (2N) id download
    # is exactly the cost the device flux route exists to avoid (20 MB of
    # int16 at 10M segments, per cleaning pass) -- dtrajs stay deferred and any later host consumer
    # materializes them once against the final bank.
    import jax as _jax

    _want_ids = not (
        _jax.process_count() == 1
        and N >= int(os.environ.get("MSM_WE_TPU_DEVICE_FLUX_MIN_ROWS",
                                    str(10**18)))
    )
    if model._parent_idx is None and strat is not None and _want_ids:
        from .parallel.sharded import (
            build_sharded_step_packed_with_ids, flux_pack_capacity,
            unpack_packed_flux,
        )
        from .discretization import _check_live_centers

        # Same junk-id guard as sharded_pair_discretize: this program
        # is about to mint the build's dtrajs
        _check_live_centers(strat, pbins, cbins)
        step = build_sharded_step_packed_with_ids(
            mesh, n_states, strat.n_total_clusters + 2,
            with_target_p=True, n_bins=n_bins,
        )
        with _scoped_x64():
            buf, both = step(*args)
        # One overlapped download: device_get issues async host copies
        # for both outputs before blocking, instead of two serial syncs
        import jax

        buf, both = jax.device_get((buf, both))
        model._store_dtrajs(*_id_columns_to_host(both, N))
        fm = unpack_packed_flux(
            np.asarray(buf), n_states, flux_pack_capacity(n_states)
        )
        if fm is not None:
            return fm
        log.debug(
            "Packed flux overflowed its nonzero capacity; re-running "
            "the dense device step."
        )
    # Matrices big enough for the download to matter go through the
    # packed-sparse variant (it downloads the nonzeros, not the dense
    # (n_states)^2 f64 matrix); an overflowing nonzero count falls back
    # to the dense program.
    elif n_states >= 96:
        from .parallel.sharded import (
            build_sharded_step_packed, flux_pack_capacity,
            unpack_packed_flux,
        )

        step = build_sharded_step_packed(
            mesh, n_states, with_target_p=True, n_bins=n_bins
        )
        with _scoped_x64():
            buf = step(*args)
        fm = unpack_packed_flux(
            np.asarray(buf), n_states, flux_pack_capacity(n_states)
        )
        if fm is not None:
            return fm
        log.debug(
            "Packed flux overflowed its nonzero capacity; re-running "
            "the dense device step."
        )
    step = build_sharded_step(mesh, n_states, with_target_p=True, n_bins=n_bins)
    with _scoped_x64():
        fm = step(*args)
    fm = np.asarray(fm, dtype=np.float64)
    assert fm.shape == (n_states, n_states)
    return fm


def get_iter_flux_matrix(model, n_iter):
    """Single-iteration flux matrix (reference ``_fluxmatrix.py:21-72``)."""
    d = model._dataset.iter_data(n_iter)
    model._ensure_discretized()
    # NaN-zeroed weights from the feature cache (already materialized by
    # the discretization above) -- iter_coord_pairs would re-read BOTH
    # full coordinate frames just to recompute this vector
    feats = model._featurize_all()
    offs = feats["offsets"]
    weights = feats["weights"][offs[n_iter - 1] : offs[n_iter]]
    pairs = np.asarray(model.pair_dtrajs[n_iter - 1])
    start_idx, end_idx = pairs[:, 0].copy(), pairs[:, 1].copy()
    n_states = model.n_clusters + 2
    end_idx = np.where(
        model.is_WE_target(d["pcoord1"]), model.n_clusters + 1, end_idx
    )
    if model.clustering_method == "stratified":
        # Same nominal-numbering routing as get_fluxMatrix: stratified
        # predict short-circuits target-region parents to its own
        # target index (n_total_clusters + 1), which pre-cleaning can be
        # a dead regular-cluster slot in the nominal n_clusters + 2
        # numbering -- route them to the nominal target row. Applied
        # BEFORE start-in-basis: with overlapping bounds, basis wins
        # (reference composition, _fluxmatrix.py:134-137)
        start_idx = np.where(
            model.is_WE_target(d["pcoord0"]), model.n_clusters + 1, start_idx
        )
    start_idx = np.where(
        model.is_WE_basis(d["pcoord0"]), model.n_clusters, start_idx
    )
    end_idx = np.where(
        model.is_WE_basis(d["pcoord1"]), model.n_clusters, end_idx
    )
    flat = start_idx.astype(np.int64) * n_states + end_idx.astype(np.int64)
    return np.bincount(flat, weights=weights, minlength=n_states**2).reshape(
        n_states, n_states
    )
