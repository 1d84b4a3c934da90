"""Discretization engine: batched (and mesh-sharded) assignment of every
segment pair to stratified cluster ids, plus the fused streaming-clustering
batch runner.

Extracted from the ``modelWE`` facade (which delegates here unchanged).
Replaces the reference's per-iteration Ray fan-out
(``msm_we/_hamsm/_clustering.py:1144-1242``) with one masked-distance matmul
over all rows -- SURVEY.md section 7's discretization redesign.
"""
from __future__ import annotations

import numpy as np

from ._logging import log
from .features import _feat_parent_rows, _id_columns_to_host, _pad_rows_to


def _check_live_centers(strat, pbins, cbins):
    """Predict-path guard shared by every device program that assigns rows
    to the stratified bank: a present (remapped) WE bin with no live
    centers and no remap would silently produce junk ids on device.
    Single implementation: ``StratifiedKmeans.check_live_bins``."""
    strat.check_live_bins(np.concatenate([pbins, cbins]))


def launch_discretization(model, progress_bar=None):
    """Discretize every iteration's parent+child features in one pass.

    Replaces the reference's per-iteration Ray fan-out
    (``launch_ray_discretization``, ``_clustering.py:1144-1242``).
    Parent and child rows go through ONE predict call (2N rows): each
    predict is a blocking dispatch+download round trip, so fusing them
    halves the number of syncs.
    """
    feats = model._featurize_all()
    strat = model._strat

    parent_bins, child_bins = model._raw_we_bins()
    n = len(parent_bins)

    if model._mesh is not None and strat is not None:
        pidx, cidx = model._sharded_pair_discretize(
            strat, parent_bins, child_bins
        )
        model._store_dtrajs(pidx, cidx)
        return

    masks = model._pc_masks()
    both_idx = strat.predict(
        np.concatenate([feats["parent"], feats["child"]]),
        np.concatenate([parent_bins, child_bins]),
        is_basis=np.concatenate([masks["basis_p"], masks["basis_c"]]),
        is_target=np.concatenate([masks["target_p"], masks["target_c"]]),
    )
    model._store_dtrajs(both_idx[:n], both_idx[n:])


def device_child_assign(model, strat):
    """Child-row cluster ids as a DEVICE-RESIDENT array (no download).

    The same dispatch the dedup fast path issues (predict-order overrides,
    bitwise-identical to host ``strat.predict``), returned without the
    host transfer: consumers that only need device-side reductions over
    the ids (``structures.get_cluster_centers``'s device stats route, the
    device flux program's byproduct path) chain on it directly. Returns
    ``(cid_dev, N)`` where rows ``[N:]`` are padding (their ids are
    unspecified -- mask them in any reduction).
    """
    from .parallel.sharded import build_sharded_single_assign

    mesh = model._mesh
    _pb, child_bins = model._raw_we_bins()
    N = len(child_bins)
    cbins = strat.we_remap[child_bins].astype(np.int32)
    strat.check_live_bins(cbins)
    masks = model._pc_masks()
    data_size = mesh.shape["data"]
    model_size = mesh.shape["model"]
    N_pad = -(-N // data_size) * data_size
    K_pad = -(-strat.n_total_clusters // model_size) * model_size
    n_states = strat.n_total_clusters + 2

    _fp, fc_dev = model._device_row_feats(need_parent=False)
    centersC, center_binC, validC = strat.compact_bank_device(pad_to=K_pad)
    assign1 = build_sharded_single_assign(mesh, n_states, n_bins=strat.n_bins)
    cid_dev = assign1(
        fc_dev,
        _pad_rows_to(cbins, N_pad, -1),
        _pad_rows_to(masks["basis_c"], N_pad, False),
        _pad_rows_to(masks["target_c"], N_pad, False),
        centersC, center_binC, validC,
    )
    return cid_dev, N


def sharded_pair_discretize(model, strat, parent_bins, child_bins):
    """One sharded dispatch assigning parent AND child rows, reading the
    shared device-resident feature arrays (``modelWE._device_row_feats``) --
    the same layout the fused flux step consumes, so features upload
    once per build instead of once per stage. Identical ids to
    ``strat.predict`` (same masked scores, same overrides)."""
    from .parallel.sharded import build_sharded_pair_assign

    feats = model._featurize_all()
    mesh = model._mesh
    N = len(parent_bins)

    pbins = strat.we_remap[parent_bins].astype(np.int32)
    cbins = strat.we_remap[child_bins].astype(np.int32)
    _check_live_centers(strat, pbins, cbins)

    masks = model._pc_masks()
    basis_p = masks["basis_p"]
    basis_c = masks["basis_c"]
    target_p = masks["target_p"]
    target_c = masks["target_c"]

    data_size = mesh.shape["data"]
    model_size = mesh.shape["model"]
    N_pad = -(-N // data_size) * data_size
    K = strat.n_total_clusters
    K_pad = -(-K // model_size) * model_size
    n_states = K + 2

    pad_rows = lambda a, fill: _pad_rows_to(a, N_pad, fill)

    # Dedup fast path: under WE continuity parent row i is a bit-copy of
    # child row src[i] (the recipe _featurize_dedup verified), and when
    # its WE bin and basis/target flags also agree with that child row
    # (pcoord continuity -- checked here, not assumed), its assignment
    # IS the child's: score only the N child rows on device (instead of
    # 2N) and gather parent ids on the host. Disagreeing/fallback rows
    # (iteration 1, recycled parents, any continuity break) go through
    # strat.predict, which matches the device scoring bitwise
    # (tests/test_coverage_round3.py pins the equality). Decided BEFORE
    # fetching the device feature arrays so the fast path never pays
    # the on-device parent gather it would not read.
    src = getattr(feats, "_parent_src", None)
    direct = s = None
    if src is not None:
        s = np.maximum(src, 0)
        agree = (
            (src >= 0)
            & (pbins == cbins[s])
            & (basis_p == basis_c[s])
            & (target_p == target_c[s])
        )
        direct = np.flatnonzero(~agree)
    fast = direct is not None and len(direct) <= max(N // 4, 1)

    fp_dev, fc_dev = model._device_row_feats(need_parent=not fast)
    # Device-side compaction: chains on the fill scans' device state with
    # no blocking host round trip for the centers
    centersC, center_binC, validC = strat.compact_bank_device(pad_to=K_pad)

    if fast:
        from .parallel.sharded import build_sharded_single_assign

        assign1 = build_sharded_single_assign(
            mesh, n_states, n_bins=strat.n_bins
        )
        cid_dev = assign1(
            fc_dev, pad_rows(cbins, -1),
            pad_rows(basis_c, False), pad_rows(target_c, False),
            centersC, center_binC, validC,
        )
        try:
            # Start the id download streaming while the host prepares the
            # disagreeing rows below: the blocking asarray then finds the
            # bytes already (mostly) landed instead of paying the full
            # device-execute + transfer wait serially afterwards
            cid_dev.copy_to_host_async()
        except Exception:
            pass
        direct_dev = None
        n2 = len(direct)
        if n2:
            # Score the fallback/disagreeing parent rows with the SAME
            # device program in a second small async dispatch (chaining on
            # the device-resident bank). Routing them through host
            # strat.predict here forced a _sync_host that blocked on the
            # whole fill-scan chain mid-stage; device scoring is
            # bitwise-identical to host predict (pinned by
            # tests/test_coverage_round3.py), so this only removes a
            # blocking round trip. Rows pad to the pow2/data-multiple
            # grid so recurring builds reuse a logarithmic set of
            # compiled shapes.
            n2_pad = 1 << max(0, n2 - 1).bit_length()
            n2_pad = -(-n2_pad // data_size) * data_size
            Xd = np.zeros((n2_pad, fc_dev.shape[1]), np.float32)
            Xd[:n2] = _feat_parent_rows(feats, direct)
            bd = np.full(n2_pad, -1, np.int32)
            bd[:n2] = pbins[direct]
            basis_d = np.zeros(n2_pad, bool)
            basis_d[:n2] = basis_p[direct]
            target_d = np.zeros(n2_pad, bool)
            target_d[:n2] = target_p[direct]
            direct_dev = assign1(
                Xd, bd, basis_d, target_d, centersC, center_binC, validC
            )
            try:
                direct_dev.copy_to_host_async()
            except Exception:
                pass
        cid = np.asarray(cid_dev)[:N].astype(np.int32)
        pid = cid[s]  # fancy indexing: already a fresh array
        if direct_dev is not None:
            pid[direct] = np.asarray(direct_dev)[:n2].astype(np.int32)
        return np.ascontiguousarray(pid), cid

    assign = build_sharded_pair_assign(
        mesh, n_states, with_target_p=True,
        n_bins=strat.n_bins,
    )
    both = assign(
        fp_dev, fc_dev,
        pad_rows(pbins, -1), pad_rows(cbins, -1),
        pad_rows(basis_p, False), pad_rows(basis_c, False),
        pad_rows(target_c, False),
        centersC, center_binC, validC,
        pad_rows(target_p, False),
    )
    # ONE device-to-host sync for both id columns (the program stacks
    # them, int16 when ids fit) instead of two separate int32 downloads
    return _id_columns_to_host(both, N)


def run_streaming_batches(model, strat, feats, batches, delegated,
                          bin_mapper, all_filled, iters_to_use,
                          scan_small_batches=False):
    """Execute the streaming-clustering batch plan, fusing runs of
    no-seeding device-path batches into single ``lax.scan`` dispatches.

    Per-batch ``partial_fit`` costs one device round trip each; at a
    hundred iterations those dispatches add up across the clustering
    stage. Batches are classified on the host (a bin
    seeds when it is uninitialized and has >= k members in the batch --
    the exact ``partial_fit`` criterion), and maximal runs of >= 2
    consecutive batches that (a) seed nothing, (b) clear
    ``HOST_BATCH_THRESHOLD`` (the device-family cutoff -- host-family
    batches keep their numerics), and (c) weren't ran-out-remapped go
    through ``StratifiedKmeans.minibatch_scan_run``, which is
    bitwise-identical to the per-batch sequence. Everything else
    delegates to ``partial_fit`` unchanged.
    """
    from .ops.stratified import HOST_BATCH_THRESHOLD

    use_weights = model.use_weights_in_clustering
    offsets = feats["offsets"]

    # Stage-internal breakdown (VERDICT r4 item 3: the 10M clustering
    # stage was a 9.7 s black box). Accumulates wall-clock per region into
    # ``model._cluster_profile``; cost is a few perf_counter calls. With
    # MSM_WE_TPU_PROFILE_CLUSTERING=1 each device dispatch is additionally
    # blocked on (``block_until_ready``) so device time lands in the
    # region that queued it -- observer-effect mode: it serializes the
    # overlap the production path exploits, so only use it to attribute.
    import os
    import time as _time

    prof = model.__dict__.setdefault("_cluster_profile", {})
    prof.update(
        scan_context_s=0.0, scan_dispatch_s=0.0, scan_dispatches=0,
        scan_rows=0, partial_fit_s=0.0, partial_fits=0, partial_fit_rows=0,
        classify_s=0.0,
    )
    blocking = os.environ.get("MSM_WE_TPU_PROFILE_CLUSTERING", "") == "1"
    prof["blocking_profile"] = blocking
    _t0 = _time.perf_counter()

    # Scan windows address contiguous row ranges; with a non-ascending
    # iteration list a batch's rows are not contiguous, so keep the
    # per-batch path (user-supplied custom orderings are tiny anyway)
    ascending = len(iters_to_use) <= 1 or bool(
        np.all(np.diff(np.asarray(iters_to_use)) > 0)
    )

    # Classify: simulate the initialized state forward (only delegated
    # batches can seed, so the simulation is exact)
    sim_init = strat.initialized.copy()
    plan = []
    for (rows, bins, ub, cnt), remapped in zip(batches, delegated):
        seeds = (~sim_init[ub]) & (cnt >= strat.k)
        live = int(cnt[sim_init[ub]].sum())
        live_floor = 1 if scan_small_batches else HOST_BATCH_THRESHOLD
        if (
            not ascending
            or remapped
            or seeds.any()
            or live < live_floor
        ):
            plan.append(False)
            sim_init[ub[seeds]] = True
        else:
            plan.append(True)
    prof["classify_s"] = _time.perf_counter() - _t0

    scan_ctx = None

    def scan_context():
        # Device-resident arrays for the scan path, built once: the
        # shared feature upload (mesh builds reuse _device_row_feats --
        # the same array the discretization/flux programs read), an
        # int16 effective-bin array (-1 = excluded from training), and
        # optionally the f32 weights
        nonlocal scan_ctx
        if scan_ctx is not None:
            return scan_ctx
        _tc = _time.perf_counter()
        import jax
        import jax.numpy as jnp

        N = int(offsets[-1])
        eff_dt = np.int16 if bin_mapper.nbins < 2**15 else np.int32
        eff = np.full(N, -1, eff_dt)
        for rows, bins, _ub, _cnt in batches:
            eff[rows] = bins
        if model._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            # Clustering only reads child features; need_parent=False keeps
            # the dedup fast path's invariant (sharded_pair_discretize skips
            # the on-device parent gather -- building it here would cache a
            # pair that already paid for it)
            X_dev = model._device_row_feats(need_parent=False)[1]
            n_pad = X_dev.shape[0]
            sh = NamedSharding(model._mesh, P("data"))

            def pad_put(a, fill):
                return jax.device_put(_pad_rows_to(a, n_pad, fill), sh)

            eff_dev = pad_put(eff, -1)
            w_dev = (
                pad_put(feats["weights"].astype(np.float32), 0.0)
                if use_weights
                else None
            )
        else:
            X_dev = jnp.asarray(feats["child"])
            eff_dev = jnp.asarray(eff)
            w_dev = (
                jnp.asarray(feats["weights"].astype(np.float32))
                if use_weights
                else None
            )
        if blocking:
            import jax as _jax

            _jax.block_until_ready(
                [a for a in (X_dev, eff_dev, w_dev) if a is not None]
            )
        scan_ctx = (X_dev, eff_dev, w_dev)
        prof["scan_context_s"] += _time.perf_counter() - _tc
        return scan_ctx

    i = 0
    while i < len(batches):
        if plan[i]:
            j = i
            while j + 1 < len(batches) and plan[j + 1]:
                j += 1
            # Default mode only fuses runs of >= 2 (a lone device-family
            # batch costs one dispatch either way); scan_small_batches
            # scans even singletons so every non-seeding batch gets the
            # same (device) numerics family
            if j > i or scan_small_batches:
                X_dev, eff_dev, w_dev = scan_context()
                starts = np.array(
                    [batches[b][0][0] for b in range(i, j + 1)], np.int64
                )
                lengths = np.array(
                    [
                        batches[b][0][-1] + 1 - batches[b][0][0]
                        for b in range(i, j + 1)
                    ],
                    np.int64,
                )
                _td = _time.perf_counter()
                strat.minibatch_scan_run(
                    X_dev, eff_dev, w_dev, starts, lengths
                )
                if blocking:
                    strat.block_on_bank()
                prof["scan_dispatch_s"] += _time.perf_counter() - _td
                prof["scan_dispatches"] += 1
                prof["scan_rows"] += int(lengths.sum())
                for b in range(i, j + 1):
                    ub = batches[b][2]
                    all_filled.update(
                        int(x) for x in ub[strat.initialized[ub]]
                    )
                i = j + 1
                continue
        rows, bins = batches[i][:2]
        _tp = _time.perf_counter()
        X = feats["child"][rows]
        w = feats["weights"][rows] if use_weights else None
        updated = strat.partial_fit(X, bins, weights=w)
        prof["partial_fit_s"] += _time.perf_counter() - _tp
        prof["partial_fits"] += 1
        prof["partial_fit_rows"] += len(rows)
        all_filled.update(updated)
        i += 1


def build_batch_plan(bin_mapper, iters_to_use, n_clusters,
                     kept_rows_all, kept_bins_all, offsets):
    """Pass 1 of stratified clustering: group iterations into fill batches.

    Accumulates iterations until every seen WE bin has >= ``n_clusters``
    kept segments (the reference's streaming fill criterion,
    ``_clustering.py:630-700``); bin counts update incrementally with each
    appended iteration, O(N) total. Returns ``(batches, delegated)`` where
    each batch is ``(rows, bins, unique_bins, counts)`` (bins after any
    ran-out remap) and ``delegated`` flags batches that must run through
    per-batch ``partial_fit`` (their members were remapped to nearest
    filled bins when the data ran out).
    """
    from .binning import find_nearest_bin

    batches = []
    delegated = []
    idx = 0
    while idx < len(iters_to_use):
        kept_rows = []
        kept_bins = []
        batch_counts = np.zeros(bin_mapper.nbins, dtype=np.int64)
        j = idx
        ran_out = False
        while True:
            if j >= len(iters_to_use):
                ran_out = True
                break
            iteration = iters_to_use[j]
            # O(log N) row range from the featurization offsets (a
            # flatnonzero scan here is O(N) per iteration -- it was the
            # dominant cost of million-segment clustering)
            if 1 <= iteration < len(offsets):
                lo, hi = np.searchsorted(
                    kept_rows_all,
                    (offsets[iteration - 1], offsets[iteration]),
                )
            else:
                lo = hi = 0
            rows_it = kept_rows_all[lo:hi]
            bins_it = kept_bins_all[lo:hi]
            kept_rows.append(rows_it)
            kept_bins.append(bins_it)
            if len(bins_it):
                batch_counts += np.bincount(
                    bins_it, minlength=bin_mapper.nbins
                )

            seen = batch_counts > 0
            if seen.any() and (batch_counts[seen] >= n_clusters).all():
                break
            j += 1

        rows = (
            np.concatenate(kept_rows) if kept_rows else np.array([], int)
        )
        if len(rows):
            bins = np.concatenate(kept_bins)
            unique_bins, counts = np.unique(bins, return_counts=True)
            unfilled = unique_bins[counts < n_clusters]
            filled = np.setdiff1d(unique_bins, unfilled)

            remapped = False
            if ran_out and len(unfilled) and len(filled):
                # Out of data: push unfilled bins' members to nearest filled
                log.warning(
                    f"Couldn't fill bins {unfilled}; remapping members to "
                    "nearest filled bins for clustering."
                )
                for ub in unfilled:
                    nearest = find_nearest_bin(bin_mapper, int(ub), list(filled))
                    bins[bins == ub] = nearest
                remapped = True
                unique_bins, counts = np.unique(bins, return_counts=True)

            batches.append((rows, bins, unique_bins, counts))
            delegated.append(remapped)

        idx = j + 1
    return batches, delegated
