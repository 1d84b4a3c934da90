"""Stratified (per-WE-bin) k-means as one flattened device tensor bank.

Re-design of the reference's ``StratifiedClusters`` (one sklearn
MiniBatchKMeans per WE bin, ``stratified_clustering.py:6-212``): all bins'
centers live in a single ``(n_bins * k, d)`` bank with per-row validity and
owning-bin ids. Prediction is a single masked distance matmul + argmin
(:func:`msm_we_tpu.ops.kmeans.masked_assign`) that returns the reference's
*consecutive global cluster indices* directly, replacing the reference's
per-frame Python loop with per-bin offsets (``stratified_clustering.py:152-203``).

Supports the reference's capability surface:
* ``we_remap`` -- unfilled/emptied bins delegate to the nearest filled bin
  (``_clustering.py:726-731,1070-1078``);
* basis/target short-circuit to the two extra cluster indices
  (``stratified_clustering.py:159-169``);
* WE-weighted clustering (``use_weights_in_clustering``,
  ``_clustering.py:853-911``);
* center deletion during flux-matrix cleaning (``_clustering.py:1041-1045``)
  via validity masking -- shapes never change, so jitted kernels never
  recompile.

Streaming training runs either per batch (:meth:`StratifiedKmeans.partial_fit`,
one fused assign+update dispatch) or as a whole run of batches in ONE
``lax.scan`` dispatch (:meth:`StratifiedKmeans.minibatch_scan_run`,
orchestrated by ``modelWE._run_streaming_batches``) -- bitwise-identical
sequential folds of the same update.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._logging import log
from .kmeans import (
    masked_assign,
    masked_minibatch_step,
    seed_bin,
    seed_bins_batched,
)

__all__ = ["StratifiedKmeans"]


def _compact_gather_impl(c, idx, v):
    # Pad/invalid rows gather row 0 then zero out -- the exact layout
    # compact_bank builds on the host (valid centers first, zeros after)
    return jnp.where(v[:, None], c[idx], 0.0)


_COMPACT_GATHER_CACHE = {}


def _compact_gather(mesh):
    """Jitted valid-row gather for :meth:`StratifiedKmeans.compact_bank_device`,
    memoized per mesh; with a mesh the output lands pre-sharded over 'model'
    (the layout every sharded assign program consumes)."""
    key = mesh
    fn = _COMPACT_GATHER_CACHE.get(key)
    if fn is None:
        if mesh is None:
            fn = jax.jit(_compact_gather_impl)
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            fn = jax.jit(
                _compact_gather_impl,
                out_shardings=NamedSharding(mesh, P("model")),
            )
        _COMPACT_GATHER_CACHE[key] = fn
    return fn

# Batches smaller than this run in plain numpy on the host: the streaming fill
# loop sees many small ragged batches, where XLA compile time dwarfs compute.
# Large batches (the real work) go through the jitted device kernels. The
# value is still to be measured on the GPU (ROADMAP).
HOST_BATCH_THRESHOLD = 4096


def _np_kmeans_pp(rng, X, w, k):
    """Weighted k-means++ in numpy (host fast path for small batches)."""
    p = w / max(w.sum(), 1e-30)
    first = rng.choice(len(X), p=p)
    centers = [X[first]]
    mind2 = ((X - X[first]) ** 2).sum(axis=1)
    for _ in range(1, k):
        scores = w * mind2
        tot = scores.sum()
        if tot <= 0:
            nxt = rng.choice(len(X), p=p)
        else:
            nxt = rng.choice(len(X), p=scores / tot)
        centers.append(X[nxt])
        mind2 = np.minimum(mind2, ((X - X[nxt]) ** 2).sum(axis=1))
    return np.array(centers)


def _np_assign(X, centers):
    d2 = (
        (X**2).sum(1)[:, None] - 2 * X @ centers.T + (centers**2).sum(1)[None, :]
    )
    return d2.argmin(axis=1)


def _np_masked_assign(X, seg_bins, centers, center_bin, valid):
    """Host masked assignment: nearest valid same-bin center per row.

    When the bank is contiguous per bin (``center_bin == repeat(arange, k)``,
    the :class:`StratifiedKmeans` layout), each row only ever competes within
    its own bin's k-slice, so scores are computed per bin block -- an
    ``n_bins``-fold flop/traffic cut over scoring the whole bank (profiled at
    ~0.13 s of a 100k-segment clustering stage).  The per-row ``|x|^2``
    constant is dropped (argmin-invariant), matching the device formula
    (:func:`ops.kmeans.masked_scores`).  Ties still break to the lowest
    global index: the block is contiguous and ascending in the bank.
    """
    K = len(centers)
    n_bins = int(center_bin[-1]) + 1 if K else 0
    k = K // n_bins if n_bins else 0
    if k and K == n_bins * k and np.array_equal(
        center_bin,
        np.repeat(np.arange(n_bins, dtype=np.asarray(center_bin).dtype), k),
    ):
        out = np.zeros(len(X), np.int64)
        c2 = (centers**2).sum(1)
        for b in np.unique(seg_bins):
            rows = np.flatnonzero(seg_bins == b)
            blk = slice(b * k, (b + 1) * k)
            scores = c2[blk][None, :] - 2.0 * (X[rows] @ centers[blk].T)
            scores[:, ~valid[blk]] = np.inf
            out[rows] = b * k + scores.argmin(axis=1)
        return out
    d2 = (
        (X**2).sum(1)[:, None] - 2 * X @ centers.T + (centers**2).sum(1)[None, :]
    )
    bad = ~(valid[None, :] & (center_bin[None, :] == seg_bins[:, None]))
    d2[bad] = np.inf
    return d2.argmin(axis=1)


def _np_lloyd(X, w, centers, n_iter):
    centers = centers.copy()
    for _ in range(n_iter):
        idx = _np_assign(X, centers)
        for c in range(len(centers)):
            m = idx == c
            wm = w[m].sum()
            if wm > 0:
                centers[c] = (X[m] * w[m, None]).sum(axis=0) / wm
    # Assignments against the FINAL centers, consistent with the device
    # path's post-Lloyd assign_flat (a stale pre-update idx mis-attributes
    # boundary points' counts)
    return centers, _np_assign(X, centers)


def _pad_pow2(X, w, bins=None):
    """Shared power-of-2 zero-weight padding (ops.pca._pad_batch_pow2)."""
    from .pca import _pad_batch_pow2

    if bins is None:
        X, w = _pad_batch_pow2(X, w)
        return X, w, None
    return _pad_batch_pow2(X, w, bins)


class StratifiedKmeans:
    """Per-WE-bin streaming k-means over a flattened center bank.

    Parameters
    ----------
    n_bins: number of WE bins.
    k_per_bin: cluster centers per bin (the reference's ``n_clusters``).
    n_features: feature dimensionality.
    seed: base RNG seed; bin ``b`` seeds with ``seed + b`` so initialization
        is deterministic and bin-order independent.
    """

    def __init__(self, n_bins, k_per_bin, n_features, seed=0):
        self.n_bins = int(n_bins)
        self.k = int(k_per_bin)
        self.d = int(n_features)
        self.seed = int(seed)
        self.mesh = None  # set via use_mesh() for multi-device prediction

        K = self.n_bins * self.k
        self.centers = np.zeros((K, self.d), np.float32)
        self.counts = np.zeros(K, np.float32)
        # When the streaming device path runs, the authoritative center/count
        # state lives on device between batches; host copies materialize
        # lazily via _sync_host() (one sync per fill loop instead of one
        # blocking np.asarray per batch)
        self._dev_state = None
        self.valid = np.zeros(K, bool)
        self.center_bin = np.repeat(np.arange(self.n_bins, dtype=np.int32), self.k)
        self.initialized = np.zeros(self.n_bins, bool)
        self.we_remap = np.arange(self.n_bins, dtype=np.int32)
        self._refresh_ids()

    # ------------------------------------------------------------ bookkeeping
    def _sync_host(self):
        """Materialize device-resident centers/counts back to host numpy."""
        if self._dev_state is not None:
            # Start BOTH transfers before blocking on either: each blocking
            # pull costs a full round trip regardless of size, and the two
            # arrays are tiny
            self.start_host_sync()
            c, n = self._dev_state
            # np.array (copy): asarray of a device array is read-only, and
            # the host paths mutate these in place
            self.centers = np.array(c)
            self.counts = np.array(n)
            self._dev_state = None

    def start_host_sync(self):
        """Begin streaming the device-resident bank to host WITHOUT
        blocking. Call when a fill loop finishes: by the time a host
        consumer hits :meth:`_sync_host` (e.g. the discretization fallback
        rows' ``predict``), the transfer has already completed and the sync
        is free instead of two blocking device round trips."""
        if self._dev_state is not None:
            for a in self._dev_state:
                try:
                    a.copy_to_host_async()
                except Exception:  # non-jax arrays under test doubles
                    pass

    def _device_state(self):
        if self._dev_state is None:
            self._dev_state = (jnp.asarray(self.centers), jnp.asarray(self.counts))
        return self._dev_state

    def block_on_bank(self):
        """Block until the device-resident bank state has finished
        computing. Profiling helper (MSM_WE_TPU_PROFILE_CLUSTERING=1):
        attributes async fill-dispatch device time to the dispatch site.
        Production paths never call this -- they rely on the async
        overlap."""
        if self._dev_state is not None:
            import jax

            try:
                jax.block_until_ready(self._dev_state)
            except Exception:  # non-jax arrays under test doubles
                pass

    def _refresh_ids(self):
        """Recompute consecutive global ids after any validity change."""
        counts_per_bin = self.valid.reshape(self.n_bins, self.k).sum(axis=1)
        # Global ids are consecutive over valid centers in bank order, and
        # the bank is ordered by bin -- cumsum-over-valid is exactly the
        # valid-rank in the flat bank
        gid = np.where(self.valid, np.cumsum(self.valid) - 1, -1).astype(np.int64)
        self.global_id = gid
        self.n_centers_per_bin = counts_per_bin
        self.n_total_clusters = int(counts_per_bin.sum())

    @property
    def basis_cluster_index(self):
        return self.n_total_clusters

    @property
    def target_cluster_index(self):
        return self.n_total_clusters + 1

    def check_live_bins(self, remapped_bins):
        """Raise if any present (already remapped) WE bin has no live
        centers: assignments against such a bin would be silent junk. The
        single home of this guard -- predict and every device program in
        model.py route through it."""
        present = np.unique(remapped_bins)
        bad = present[
            ~self.initialized[present] | (self.n_centers_per_bin[present] == 0)
        ]
        if len(bad):
            raise RuntimeError(
                f"Bins {bad} have no live cluster centers and no remap. "
                "Cluster more data or remap these bins."
            )

    def centers_of_bin(self, b):
        """Valid centers of bin b, in global-id order (compat view)."""
        self._sync_host()
        rows = np.flatnonzero(self.valid[b * self.k : (b + 1) * self.k]) + b * self.k
        return self.centers[rows]

    # ------------------------------------------------------------- training
    def partial_fit(self, X, seg_bins, weights=None):
        """One streaming update with a batch of features and their WE bins.

        Uninitialized bins that receive >= k members are seeded with weighted
        k-means++ plus a few Lloyd sweeps over their batch members; already
        initialized bins get a running-weighted-mean minibatch update.
        Returns the set of bins updated.
        """
        X = np.asarray(X, np.float32)
        seg_bins = np.asarray(seg_bins)
        w = (
            np.asarray(weights, np.float32)
            if weights is not None
            else np.ones(len(X), np.float32)
        )

        unique_bins = np.unique(seg_bins)

        # Snapshot BEFORE seeding: a bin initialized in this call already
        # consumed its members (k-means++ + Lloyd + counts); routing them
        # through the minibatch update below too would double-count the
        # seed batch's weights and take an extra half-step on the centers
        # (sklearn's partial_fit counts a first batch once)
        initialized_before = self.initialized.copy()
        seeded = False

        # Initialize any new bins that now have enough members. Host-family
        # seeds (small batches) run inline; device-family seeds are
        # collected and run as ONE batched program -- per-bin seed_bin
        # dispatches compiled a fresh program per distinct member count
        device_seeds = []
        for b in unique_bins:
            if self.initialized[b]:
                continue
            members = np.flatnonzero(seg_bins == b)
            if len(members) < self.k:
                continue
            # Seeding writes host rows; pull any device-resident state first
            self._sync_host()
            rows = slice(b * self.k, (b + 1) * self.k)
            if len(members) < HOST_BATCH_THRESHOLD:
                rng = np.random.default_rng(self.seed + int(b))
                init = _np_kmeans_pp(rng, X[members], w[members], self.k)
                cb, idx = _np_lloyd(X[members], w[members], init, n_iter=5)
                wsum = np.bincount(idx, weights=w[members], minlength=self.k)
                self.centers[rows] = cb
                self.counts[rows] = wsum
            else:
                device_seeds.append((int(b), members))
            self.valid[rows] = True
            self.initialized[b] = True
            seeded = True
        if device_seeds:
            # Shared zero-weight-padded shape: all bins seed under one
            # compile/dispatch/download (padded rows are inert throughout)
            P = 1 << int(np.ceil(np.log2(max(len(m) for _, m in device_seeds))))
            Xs = np.zeros((len(device_seeds), P, X.shape[1]), np.float32)
            ws = np.zeros((len(device_seeds), P), np.float32)
            for i, (_b, m) in enumerate(device_seeds):
                Xs[i, : len(m)] = X[m]
                ws[i, : len(m)] = w[m]
            seeds_arr = np.asarray(
                [self.seed + b for b, _m in device_seeds], np.uint32
            )
            packed = np.asarray(
                seed_bins_batched(
                    jnp.asarray(seeds_arr), jnp.asarray(Xs), jnp.asarray(ws),
                    self.k,
                )
            )
            for i, (b, _m) in enumerate(device_seeds):
                rows = slice(b * self.k, (b + 1) * self.k)
                self.centers[rows] = packed[i, :, :-1]
                self.counts[rows] = packed[i, :, -1]

        # Minibatch update for all previously-initialized bins' members in
        # one scatter (bins seeded above already consumed this batch).
        # Bins emptied by cleaning (initialized but zero valid centers) are
        # excluded: their members would otherwise argmin-fall-through onto an
        # invalidated center row and silently corrupt it
        trainable = initialized_before & (self.n_centers_per_bin > 0)
        if (initialized_before & ~trainable)[unique_bins].any():
            log.debug(
                "partial_fit batch contains members of emptied bins; "
                "their contribution is skipped (bins have no valid centers)"
            )
        live = np.flatnonzero(trainable[seg_bins])
        if len(live):
            if len(live) < HOST_BATCH_THRESHOLD:
                self._sync_host()
                Xl, wl, bl = X[live], w[live], seg_bins[live]
                idx = _np_masked_assign(
                    Xl, bl, self.centers, self.center_bin, self.valid
                )
                wsum = np.bincount(idx, weights=wl, minlength=len(self.counts))
                xsum = np.zeros_like(self.centers, dtype=np.float64)
                np.add.at(xsum, idx, Xl * wl[:, None])
                new_counts = self.counts + wsum
                upd = new_counts > 0
                self.centers[upd] = (
                    (self.centers[upd] * self.counts[upd, None] + xsum[upd])
                    / new_counts[upd, None]
                ).astype(np.float32)
                self.counts = new_counts.astype(np.float32)
            else:
                Xl_np, wl_np, bl_np = _pad_pow2(
                    X[live], w[live], seg_bins[live].astype(np.int32)
                )
                centers_d, counts_d = self._device_state()
                # Fused assign+update: one dispatch and one upload per batch
                new_centers, new_counts = masked_minibatch_step(
                    centers_d,
                    counts_d,
                    jnp.asarray(Xl_np),
                    jnp.asarray(wl_np),
                    jnp.asarray(bl_np),
                    jnp.asarray(self.center_bin),
                    jnp.asarray(self.valid),
                    n_bins=self.n_bins,
                )
                # Stay device-resident: no blocking host conversion per
                # batch; _sync_host() materializes once when next read
                self._dev_state = (new_centers, new_counts)

        # Minibatch updates never change validity, so the id tables are
        # already current unless this batch seeded a bin
        if seeded:
            self._refresh_ids()
        return set(int(b) for b in unique_bins if self.initialized[b])

    def minibatch_scan_run(self, X_dev, eff_bin_dev, w_dev, starts, lengths):
        """One fused dispatch for a run of no-seeding streaming batches.

        Equivalent to calling :meth:`partial_fit` once per batch (the
        device family: every batch must clear ``HOST_BATCH_THRESHOLD``),
        but the whole run is a single ``lax.scan`` program
        (:func:`ops.kmeans.masked_minibatch_scan`) reading row windows
        from the shared device-resident feature array -- no per-batch
        dispatch round trips and no per-batch feature uploads. The caller
        guarantees no batch in the run seeds a bin, so ``initialized``/
        ``valid``/ids are unchanged and only the device center/count state
        advances.
        """
        from .kmeans import masked_minibatch_scan

        max_len = int(np.max(lengths))
        window = max(1 << (max_len - 1).bit_length(), 64)
        # Row indices are start + iota(window): int32 unless the feature
        # array itself has > int32-max rows (matches _device_parent_from_child)
        idx_dt = (
            np.int64
            if X_dev.shape[0] > np.iinfo(np.int32).max
            else np.int32
        )
        # Pad the batch COUNT to a power of two with zero-length batches
        # (identity steps in the scan): without this every distinct run
        # length traces a separate lax.scan program -- the compiles the
        # scan exists to amortize
        starts = np.asarray(starts, idx_dt)
        lengths = np.asarray(lengths, idx_dt)
        nb = len(starts)
        nb_pad = 1 << max(nb - 1, 1).bit_length()
        if nb_pad != nb:
            starts = np.concatenate([starts, np.zeros(nb_pad - nb, idx_dt)])
            lengths = np.concatenate([lengths, np.zeros(nb_pad - nb, idx_dt)])
        centers_d, counts_d = self._device_state()
        c, n = masked_minibatch_scan(
            centers_d,
            counts_d,
            X_dev,
            eff_bin_dev,
            w_dev,
            jnp.asarray(self.initialized),
            jnp.asarray(starts),
            jnp.asarray(lengths),
            jnp.asarray(self.center_bin),
            jnp.asarray(self.valid),
            n_bins=self.n_bins,
            window=window,
        )
        self._dev_state = (c, n)

    # ------------------------------------------------------------ prediction
    def predict(self, X, seg_bins, is_basis=None, is_target=None):
        """Global cluster indices for features X in WE bins ``seg_bins``.

        Applies ``we_remap`` first; basis/target segments short-circuit to the
        two extra indices (``n_total_clusters``, ``n_total_clusters + 1``).
        """
        X = np.asarray(X, np.float32)
        seg_bins = self.we_remap[np.asarray(seg_bins)]
        self.check_live_bins(seg_bins)
        if self.mesh is not None and len(X) >= HOST_BATCH_THRESHOLD:
            return self._predict_sharded(X, seg_bins, is_basis, is_target)
        if len(X) < HOST_BATCH_THRESHOLD:
            self._sync_host()
            flat = _np_masked_assign(
                X, seg_bins, self.centers, self.center_bin, self.valid
            )
        else:
            # Reuse any pending device-resident bank: no blocking download +
            # re-upload round trip right after a streaming fill. Rows are
            # padded to a power of two (inert bin -1, sliced off below) so
            # distinct segment counts reuse a logarithmic set of compiled
            # shapes instead of one XLA compile per N -- the padding
            # discipline every other device entry point already follows
            centers_d, _counts_d = self._device_state()
            N = len(X)
            Xp, _wp, bp = _pad_pow2(
                X, np.ones(N, np.float32), seg_bins.astype(np.int32)
            )
            bp[N:] = -1  # inert padding rows (empty slice when N was pow2)
            flat = np.asarray(
                masked_assign(
                    jnp.asarray(Xp),
                    jnp.asarray(bp),
                    centers_d,
                    jnp.asarray(self.center_bin),
                    jnp.asarray(self.valid),
                    n_bins=self.n_bins,
                )
            )[:N]
        out = self.global_id[flat]

        if is_basis is not None:
            out = np.where(np.asarray(is_basis), self.basis_cluster_index, out)
        if is_target is not None:
            out = np.where(np.asarray(is_target), self.target_cluster_index, out)
        return out

    def use_mesh(self, mesh):
        """Route large predictions through a (data, model) device mesh."""
        self.mesh = mesh
        self._sharded_assign = None

    def __getstate__(self):
        # Meshes/jitted callables are process-local; checkpoints re-enable
        # the mesh after loading. Device-resident centers materialize to
        # host before pickling.
        self._sync_host()
        state = self.__dict__.copy()
        state["mesh"] = None
        state["_sharded_assign"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if "_dev_state" not in state:  # legacy pickles
            self._dev_state = None

    def _predict_sharded(self, X, seg_bins, is_basis, is_target):
        """Mesh-sharded prediction: segments data-parallel, bank
        tensor-parallel. Identical results to the single-device path
        (equivalence tested on the virtual CPU mesh)."""
        from ..parallel.sharded import build_sharded_assign

        if getattr(self, "_sharded_assign", None) is None:
            self._sharded_assign = build_sharded_assign(self.mesh, n_bins=self.n_bins)

        data_size = self.mesh.shape["data"]
        model_size = self.mesh.shape["model"]
        N = len(X)
        N_pad = -(-N // data_size) * data_size
        K = self.n_total_clusters
        K_pad = -(-K // model_size) * model_size

        Xp = np.zeros((N_pad, X.shape[1]), np.float32)
        Xp[:N] = X
        bp = np.full(N_pad, -1, np.int32)
        bp[:N] = seg_bins
        # Compact bank: the sharded assign returns global ids directly
        # (device-side gather when the fill scans left the state on device)
        Cp, cbp, vp = self.compact_bank_device(pad_to=K_pad)

        out = np.asarray(self._sharded_assign(Xp, bp, Cp, cbp, vp))[:N]
        if is_basis is not None:
            out = np.where(np.asarray(is_basis), self.basis_cluster_index, out)
        if is_target is not None:
            out = np.where(np.asarray(is_target), self.target_cluster_index, out)
        return out

    def compact_bank(self, pad_to=None):
        """(centers, center_bin, valid) with valid centers first, in
        global-id order -- the layout the fused device kernels require, so
        the assignment argmin row IS the global cluster id (no runtime
        global_id gather; see ``parallel.sharded._local_masked_min``).

        Global ids are assigned in ascending row order (``_refresh_ids``),
        so compaction is a stable selection of the valid rows. ``pad_to``
        appends invalid rows (bin -2) up to a fixed size.
        """
        self._sync_host()
        rows = np.flatnonzero(self.valid)
        n = len(rows)
        K = n if pad_to is None else int(pad_to)
        assert K >= n
        centers = np.zeros((K, self.d), np.float32)
        center_bin = np.full(K, -2, np.int32)
        valid = np.zeros(K, bool)
        centers[:n] = self.centers[rows]
        center_bin[:n] = self.center_bin[rows]
        valid[:n] = True
        return centers, center_bin, valid

    def compact_bank_device(self, pad_to=None):
        """``compact_bank`` without the device-to-host sync.

        When the authoritative center state is device-resident (a
        ``minibatch_scan_run`` fill just ran), the compaction row selection
        depends only on ``self.valid`` -- which the scans never change
        (seeding and cleaning are host operations that sync first) -- so the
        valid-row gather can run ON DEVICE and chain directly into the next
        assignment program, without the host round trip (wait for the fill
        scans + pull the center bank) that a host compaction needs.

        Returns ``(centers, center_bin, valid)`` where ``centers`` is a
        device array (host numpy when no device state exists -- then this is
        exactly :meth:`compact_bank`). ``center_bin``/``valid`` are host
        numpy either way (they are host-derived metadata the callers pad
        and pass through).
        """
        if self._dev_state is None:
            return self.compact_bank(pad_to=pad_to)
        rows = np.flatnonzero(self.valid)
        n = len(rows)
        K = n if pad_to is None else int(pad_to)
        assert K >= n
        center_bin = np.full(K, -2, np.int32)
        valid = np.zeros(K, bool)
        center_bin[:n] = self.center_bin[rows]
        valid[:n] = True
        idx = np.zeros(K, np.int32)
        idx[:n] = rows
        centers = _compact_gather(self.mesh)(
            self._dev_state[0], jnp.asarray(idx), jnp.asarray(valid)
        )
        return centers, center_bin, valid

    def device_args(self):
        """The device-resident arrays a fused jit pipeline needs (compact
        bank layout; argmin row == global cluster id)."""
        centers, center_bin, valid = self.compact_bank()
        return dict(
            centers=jnp.asarray(centers),
            center_bin=jnp.asarray(center_bin),
            valid=jnp.asarray(valid),
            we_remap=jnp.asarray(self.we_remap),
        )

    # -------------------------------------------------------------- cleaning
    def remove_global_clusters(self, global_ids_to_remove):
        """Invalidate the centers with the given global ids.

        Returns the set of WE bins left with no centers (to be remapped by the
        caller, reference ``_clustering.py:1057-1078``). Global ids are then
        recomputed so the surviving centers are consecutively indexed.
        """
        global_ids_to_remove = np.asarray(global_ids_to_remove, dtype=np.int64)
        if len(global_ids_to_remove):
            inverse = {g: i for i, g in enumerate(self.global_id) if g >= 0}
            rows = np.array([inverse[g] for g in global_ids_to_remove])
            self.valid[rows] = False
        self._refresh_ids()

        emptied = set()
        for b in range(self.n_bins):
            if self.initialized[b] and self.n_centers_per_bin[b] == 0:
                emptied.add(b)
        return emptied

    def set_remap(self, bin_idx, target_bin):
        log.debug(f"Remapping WE bin {bin_idx} -> {target_bin}")
        self.we_remap[bin_idx] = target_bin
        # Path-compress chains: a bin remapped to B where B was later
        # remapped to C must resolve to C, or predict would score against
        # B's invalidated centers and silently return garbage ids
        for _ in range(self.n_bins):
            chained = self.we_remap[self.we_remap]
            if np.array_equal(chained, self.we_remap):
                break
            self.we_remap = chained
