"""Cluster-center statistics and cluster-structure export.

Extracted from the ``modelWE`` facade (which delegates here unchanged).
Capability parity with the reference's ``get_cluster_centers`` /
``update_cluster_structures`` (``msm_we/_hamsm/_clustering.py:1528-1599,
1398-1526``), rewritten as grouped array passes (bincount / sort +
``ufunc.reduceat``) instead of per-cluster Python loops.
"""
from __future__ import annotations

import os

import numpy as np

from ._logging import log

#: Row count above which a mesh build with still-deferred assignments
#: computes the per-cluster pcoord stats ON DEVICE instead of
#: materializing host dtrajs. Below it, the ids are cheap to download
#: (and often already in hand) and the host f64 path is exact.
DEVICE_STATS_MIN_ROWS_ENV = "MSM_WE_TPU_DEVICE_STATS_MIN_ROWS"


def _device_stats_route(model):
    if getattr(model, "_mesh", None) is None:
        return False
    if getattr(model, "_child_idx", None) is not None:
        return False  # ids already on host: the f64 host path is free
    if getattr(model, "_strat", None) is None:
        return False
    feats = model._featurize_all()
    n_rows = int(feats["offsets"][-1])
    # Disabled by default (10**18 rows) alongside the device flux route
    # (see fluxmatrix.get_flux_matrix): with host-materialized ids the f64
    # host stats are free. Active when the device-resident regime is
    # opted into (multi-process, or the env knobs). The crossover is still
    # to be measured on the GPU (ROADMAP).
    return n_rows >= int(
        os.environ.get(DEVICE_STATS_MIN_ROWS_ENV, str(10**18))
    )


def get_cluster_centers(model):
    """Mean/min/max child-pcoord per cluster; returns the pcoord-sort
    permutation (reference ``_clustering.py:1528-1599``).

    Basis/target rows get NaN centers, so the stable argsort pins them to
    the last two positions -- the property that makes
    ``indBasis = [n_clusters]`` correct after sorting.

    On big mesh builds with deferred assignments the stats come from a
    device program reading the device-resident ids and pcoords
    (:func:`_get_cluster_centers_device`) -- the one per-cleaning-pass
    consumer that otherwise forced a full (N,) assignment download.
    """
    if _device_stats_route(model):
        try:
            return _get_cluster_centers_device(model)
        except Exception as e:  # pragma: no cover - fall back to exact host
            log.warning(f"device cluster-stats route failed ({e}); "
                        "falling back to host path")

    n = model.n_clusters
    centers = np.full((n + 2, model.pcoord_ndim), np.nan)
    crange = np.full((n + 2, model.pcoord_ndim, 2), np.nan)

    feats = model._featurize_all()
    model._ensure_discretized()
    child_idx = model._child_idx
    p1 = feats["pcoord1"]

    # Grouped mean/min/max in one pass per statistic (bincount for
    # count/sum; a group sort + ufunc.reduceat for min/max -- ufunc.at
    # is an unbuffered scalar loop, ~3 s at 2M rows where the sort-based
    # grouping is ~0.3 s) instead of an O(n_clusters * N) masked python
    # loop -- this runs inside every cleaning pass
    in_range = np.flatnonzero((child_idx >= 0) & (child_idx < n))
    idx = child_idx[in_range]
    vals = p1[in_range]
    good = ~np.isnan(vals)
    counts = np.zeros((n, model.pcoord_ndim))
    sums = np.zeros((n, model.pcoord_ndim))
    mins = np.full((n, model.pcoord_ndim), np.inf)
    maxs = np.full((n, model.pcoord_ndim), -np.inf)
    for dim in range(model.pcoord_ndim):
        g = np.flatnonzero(good[:, dim])
        gi = idx[g]
        gv = vals[g, dim]
        counts[:, dim] = np.bincount(gi, minlength=n)
        sums[:, dim] = np.bincount(gi, weights=gv, minlength=n)
        if len(gi):
            order_g = np.argsort(gi, kind="stable")
            gis = gi[order_g]
            gvs = gv[order_g]
            starts = np.r_[0, np.flatnonzero(np.diff(gis)) + 1]
            present = gis[starts]
            mins[present, dim] = np.minimum.reduceat(gvs, starts)
            maxs[present, dim] = np.maximum.reduceat(gvs, starts)
    populated = counts > 0
    centers[:n][populated] = sums[populated] / counts[populated]
    crange[:n, :, 0][populated] = mins[populated]
    crange[:n, :, 1][populated] = maxs[populated]
    empty = np.flatnonzero(~populated.any(axis=1))
    for cluster in empty:
        log.warning(f"No trajectories in cluster {cluster}!")

    order = np.argsort(centers[:, 0], kind="stable")
    model.targetRMSD_centers = centers[order]
    model.targetRMSD_minmax = crange[order]
    return order


def _device_p1(model, N_pad):
    """Device-resident child pcoords, NaN-padded to ``N_pad`` and cached
    per feature set."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    feats = model._featurize_all()
    cache = getattr(model, "_device_p1_cache", None)
    if cache is not None and cache[0] is feats and cache[1] == N_pad:
        return cache[2]
    p1 = np.asarray(feats["pcoord1"], dtype=np.float32)
    if p1.ndim == 1:
        p1 = p1[:, None]
    out = np.full((N_pad, p1.shape[1]), np.nan, np.float32)
    out[: len(p1)] = p1
    dev = jax.device_put(out, NamedSharding(model._mesh, P("data")))
    model._device_p1_cache = (feats, N_pad, dev)
    return dev


def _get_cluster_centers_device(model):
    """Device route for :func:`get_cluster_centers`: ids and pcoords stay
    on device; only four ``(k_max + 1, ndim)`` tables come back.

    Mirrors the host path's semantics exactly -- per-dimension NaN
    exclusion, NaN centers for empty/basis/target rows, stable pcoord
    argsort -- with f32 scatter sums (documented serving tier; pcoord
    means agree with the host f64 path to ~sqrt(N)*eps relative, far
    inside typical inter-center spacing)."""
    from .discretization import device_child_assign
    from .parallel.sharded import build_sharded_cluster_stats

    strat = model._strat
    n = model.n_clusters
    ndim = int(model.pcoord_ndim)
    k_max = int(strat.n_bins * strat.k)

    cid_dev, N = device_child_assign(model, strat)
    p1_dev = _device_p1(model, int(cid_dev.shape[0]))
    stats = build_sharded_cluster_stats(model._mesh, k_max, ndim)
    counts, sums, vmin, vmax = stats(cid_dev, p1_dev, np.int32(n))
    counts = np.asarray(counts)[:n].astype(np.float64)
    sums = np.asarray(sums)[:n].astype(np.float64)
    vmin = np.asarray(vmin)[:n].astype(np.float64)
    vmax = np.asarray(vmax)[:n].astype(np.float64)

    centers = np.full((n + 2, ndim), np.nan)
    crange = np.full((n + 2, ndim, 2), np.nan)
    populated = counts > 0
    centers[:n][populated] = sums[populated] / counts[populated]
    crange[:n, :, 0][populated] = vmin[populated]
    crange[:n, :, 1][populated] = vmax[populated]
    for cluster in np.flatnonzero(~populated.any(axis=1)):
        log.warning(f"No trajectories in cluster {cluster}!")

    order = np.argsort(centers[:, 0], kind="stable")
    model.targetRMSD_centers = centers[order]
    model.targetRMSD_minmax = crange[order]
    return order


def update_cluster_structures(model, build_pcoord_cache=False):
    """Map each cluster to its member structures, weights, and provenance
    (reference ``_clustering.py:1398-1526``).

    Grouping is one stable argsort + split over the concatenated arrays
    instead of the reference's per-segment python loop -- O(N log N)
    array work, so it stays off the critical path even at millions of
    segments (the restart driver calls this every restart).
    """
    assert model.clusters is not None, "Clusters have not been computed!"
    model._ensure_discretized()

    coords_parts, weights_parts, dtraj_parts = [], [], []
    iter_parts, segidx_parts, westidx_parts, pcoord_parts = [], [], [], []
    for iteration in range(1, model.maxIter - 1):
        d = model._dataset.iter_data(iteration)
        coords_parts.append(model._dataset._iter_frame_block(iteration, -1))
        weights_parts.append(d["weights"])
        dtraj_parts.append(np.asarray(model.dtrajs[iteration - 1]))
        iter_parts.append(np.full(d["n_segs"], iteration))
        segidx_parts.append(d["seg_idx"])
        westidx_parts.append(d["west_idx"])
        if build_pcoord_cache:
            pcoord_parts.append(d["pcoord1"])

    if not dtraj_parts:  # fewer than 3 usable iterations: nothing to map
        model.cluster_structures = {}
        model.cluster_structure_weights = {}
        model.structure_iteration_segments = {}
        model.pcoord_cache = {} if build_pcoord_cache else None
        return

    dtraj = np.concatenate(dtraj_parts)
    order = np.argsort(dtraj, kind="stable")
    sorted_clusters = dtraj[order]
    uniq, starts = np.unique(sorted_clusters, return_index=True)
    bounds = np.append(starts[1:], len(sorted_clusters))

    coords = np.concatenate(coords_parts)[order]
    weights = np.concatenate(weights_parts)[order]
    iters = np.concatenate(iter_parts)[order]
    segidx = np.concatenate(segidx_parts)[order]
    westidx = np.concatenate(westidx_parts)[order]
    pcoords = np.concatenate(pcoord_parts)[order] if build_pcoord_cache else None

    cluster_structures = {}
    cluster_structure_weights = {}
    structure_iteration_segments = {}
    pcoord_cache = {} if build_pcoord_cache else None
    for c, a, b in zip(uniq, starts, bounds):
        c = int(c)
        cluster_structures[c] = list(coords[a:b])
        cluster_structure_weights[c] = list(weights[a:b])
        structure_iteration_segments[c] = [
            [int(it), int(si), model.fileList[int(wi)]]
            for it, si, wi in zip(iters[a:b], segidx[a:b], westidx[a:b])
        ]
        if build_pcoord_cache:
            pcoord_cache[c] = list(pcoords[a:b])

    model.cluster_structures = cluster_structures
    model.cluster_structure_weights = cluster_structure_weights
    model.structure_iteration_segments = structure_iteration_segments
    model.pcoord_cache = pcoord_cache
