"""Batched, weighted k-means primitives in JAX.

This replaces the reference's sklearn KMeans/MiniBatchKMeans usage
(``_clustering.py:41-140``, ``stratified_clustering.py:101-212``). The hottest
reference loop -- one sklearn ``predict([coord])`` call per frame inside
``StratifiedClusters.predict`` (``stratified_clustering.py:152-203``) -- becomes
one masked distance matmul + argmin over a *flattened* center bank:

* all per-WE-bin cluster centers live in one ``(K, d)`` tensor with a
  ``center_bin`` id and ``valid`` mask per row;
* a segment's distances to centers outside its (remapped) WE bin are pushed to
  +inf, so the argmin simultaneously picks the bin-local nearest center and,
  through a precomputed ``global_id`` lookup, yields the reference's
  consecutive global cluster index (offset logic of
  ``stratified_clustering.py:173-195``).

The distance computation is ``|x|^2 - 2 x.C^T + |c|^2`` -- one GEMM that XLA
fuses with the masking and argmin; this module is also the training-update
home.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "pairwise_dist2",
    "assign_flat",
    "masked_scores",
    "masked_assign",
    "kmeans_plusplus",
    "lloyd",
    "minibatch_update",
]

# Plain Python floats (weak types in jax): a module-level jnp array would
# initialize the XLA backend at import time, which breaks processes that
# must call jax.distributed.initialize() first
_BIG = float(np.float32(3.4e38))


# All distance/score matmuls run at Precision.HIGHEST: at default precision
# the GPU may run f32 GEMMs in TF32 (10 mantissa bits), which flips
# assignments for near-equidistant centers (chip_smoke.py's hot-step phase
# reports the share of rows that change). The reference computes distances
# in f64 -- reduced-precision scores would be a silent semantic deviation.
_HI = jax.lax.Precision.HIGHEST


def pairwise_dist2(X, C):
    """Squared Euclidean distances, (N, d) x (K, d) -> (N, K), via one GEMM."""
    x2 = jnp.sum(X * X, axis=1, keepdims=True)
    c2 = jnp.sum(C * C, axis=1)[None, :]
    xc = jnp.matmul(X, C.T, precision=_HI)
    return x2 - 2.0 * xc + c2


@jax.jit
def assign_flat(X, C, valid):
    """Nearest valid center for each row of X. Returns (indices, dist2)."""
    d2 = pairwise_dist2(X, C)
    d2 = jnp.where(valid[None, :], d2, _BIG)
    idx = jnp.argmin(d2, axis=1)
    return idx, jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0]


_PEN = float(np.float32(1e30))

# Above this many WE bins the one-hot penalty block would dominate the GEMM
# contraction dimension; fall back to the elementwise mask. The crossover
# is still to be measured on the GPU (ROADMAP).
_MAX_ONEHOT_BINS = 64


def masked_scores(X, seg_bin, C, center_bin, valid, n_bins=None, precision=None):
    """Stratified assignment scores: per row, every valid center in the row's
    WE bin scores ``|c|^2 - 2 x.c``, everything else a large penalty.

    The SINGLE implementation shared by the host predict path
    (:func:`masked_assign`) and the fused/sharded device step
    (``parallel.sharded._local_masked_min``): their argmins being
    bit-identical depends on matched scores coming from the same formula.

    With ``n_bins`` given (static, and modest), the bin mask is folded INTO
    the GEMM as a one-hot X block x penalty C block, so no (N, K)
    elementwise mask pass breaks XLA's matmul->argmin fusion. Both paths
    emit the same ``|c|^2 - 2 x.c`` values (no row-dependent constant), so
    scores are comparable across center-bank shards.
    """
    prec = _HI if precision is None else precision
    if n_bins is not None and n_bins <= _MAX_ONEHOT_BINS:
        c2v = jnp.where(valid, jnp.sum(C * C, axis=1), _PEN)
        # Out-of-range bins (e.g. the -1 padding convention) route to an
        # extra all-penalty class: one_hot(-1) alone would be all-zeros,
        # scoring the row un-penalized against every center. The extra
        # class contributes exactly 0.0 to in-range rows' scores, so their
        # values are bit-identical with or without it.
        safe_bin = jnp.where(
            (seg_bin >= 0) & (seg_bin < n_bins), seg_bin, n_bins
        )
        onehot = jax.nn.one_hot(safe_bin, n_bins + 1, dtype=X.dtype)
        Xa = jnp.concatenate([X, onehot], axis=1)
        pen_block = jnp.where(
            center_bin[None, :] == jnp.arange(n_bins)[:, None], 0.0, _PEN
        )
        pen_block = jnp.concatenate(
            [pen_block, jnp.full((1, C.shape[0]), _PEN, X.dtype)], axis=0
        )
        Ca = jnp.concatenate([-2.0 * C.T, pen_block], axis=0)
        return jnp.matmul(Xa, Ca, precision=prec) + c2v[None, :]
    scores = jnp.sum(C * C, axis=1)[None, :] - 2.0 * jnp.matmul(
        X, C.T, precision=prec
    )
    ok = valid[None, :] & (center_bin[None, :] == seg_bin[:, None])
    return jnp.where(ok, scores, _BIG)


@partial(jax.jit, static_argnames=("n_bins",))
def masked_assign(X, seg_bin, C, center_bin, valid, n_bins=None):
    """Stratified assignment: nearest valid center *within each row's WE bin*.

    Parameters
    ----------
    X: (N, d) features.
    seg_bin: (N,) int32 -- the (already we_remap'ed) WE bin of each segment.
    C: (K, d) flattened center bank.
    center_bin: (K,) int32 -- owning WE bin of each center row.
    valid: (K,) bool -- live centers (False = padding or cleaned).
    n_bins: static WE bin count (see :func:`masked_scores`).

    Returns the flat center-row index (into C) of the winner for each segment.
    """
    return jnp.argmin(
        masked_scores(X, seg_bin, C, center_bin, valid, n_bins=n_bins), axis=1
    )


@partial(jax.jit, static_argnames=("k",))
def kmeans_plusplus(key, X, w, k):
    """Weighted k-means++ seeding (deterministic given ``key``).

    Rows with weight 0 are never chosen. Returns (k, d) initial centers.
    """
    n = X.shape[0]
    w = jnp.maximum(w, 0.0)
    probs0 = w / jnp.maximum(w.sum(), 1e-30)

    key, sub = jax.random.split(key)
    first = jax.random.choice(sub, n, p=probs0)
    centers0 = jnp.zeros((k, X.shape[1]), X.dtype).at[0].set(X[first])
    mind2_0 = jnp.sum((X - X[first]) ** 2, axis=1)

    def body(i, carry):
        key, centers, mind2 = carry
        key, sub = jax.random.split(key)
        scores = w * mind2
        tot = scores.sum()
        # All-zero scores (every distinct point already a center -- routine
        # after WE splitting duplicates coordinates): fall back to the base
        # weight distribution, as the host seeder does, instead of letting
        # choice degenerate to index 0
        # Divide by the true total when positive (a 1e-30 clamp would skew
        # the distribution whenever the f32 weight sum is below the clamp)
        p = jnp.where(tot > 0, scores / jnp.where(tot > 0, tot, 1.0), probs0)
        nxt = jax.random.choice(sub, n, p=p)
        centers = centers.at[i].set(X[nxt])
        mind2 = jnp.minimum(mind2, jnp.sum((X - X[nxt]) ** 2, axis=1))
        return key, centers, mind2

    _key, centers, _m = jax.lax.fori_loop(1, k, body, (key, centers0, mind2_0))
    return centers


@partial(jax.jit, static_argnames=("n_iter",))
def lloyd(X, w, centers, n_iter=25):
    """Weighted batch Lloyd iterations with fixed iteration count.

    Empty clusters keep their previous center (sklearn re-seeds them; a fixed
    center is deterministic and shape-stable under jit).
    """
    k = centers.shape[0]

    def step(_i, centers):
        idx, _ = assign_flat(X, centers, jnp.ones(k, bool))
        wsum = jax.ops.segment_sum(w, idx, num_segments=k)
        xsum = jax.ops.segment_sum(X * w[:, None], idx, num_segments=k)
        # Exact divisor: clamping to 1e-30 collapsed centers toward the
        # origin for clusters whose total f32 weight is in (0, 1e-30) --
        # normal for WE weights spanning hundreds of orders of magnitude.
        # The host path (stratified._np_lloyd) divides exactly; the two
        # numerics families must agree on this
        denom = jnp.where(wsum > 0, wsum, 1.0)
        new = jnp.where(wsum[:, None] > 0, xsum / denom[:, None], centers)
        return new

    return jax.lax.fori_loop(0, n_iter, step, centers)


@jax.jit
def minibatch_update(centers, counts, X, w, idx):
    """Streaming (running weighted mean) center update, MiniBatchKMeans-style.

    ``idx`` are flat center-row assignments for this batch; rows with w == 0
    contribute nothing. Returns (new_centers, new_counts).
    """
    k = centers.shape[0]
    wsum = jax.ops.segment_sum(w, idx, num_segments=k)
    xsum = jax.ops.segment_sum(X * w[:, None], idx, num_segments=k)
    new_counts = counts + wsum
    # Exact divisor (see lloyd): a 1e-30 clamp collapses the running mean
    # for sub-clamp f32 weight totals
    denom = jnp.where(new_counts > 0, new_counts, 1.0)
    new_centers = jnp.where(
        new_counts[:, None] > 0,
        (centers * counts[:, None] + xsum) / denom[:, None],
        centers,
    )
    return new_centers, new_counts


@partial(jax.jit, static_argnames=("n_bins",))
def masked_minibatch_step(centers, counts, X, w, seg_bin, center_bin, valid,
                          n_bins=None):
    """Fused stratified assign + running-mean update: ONE device dispatch per
    streaming batch. Identical ops to masked_assign followed by
    minibatch_update (the nested jitted calls inline): halving the
    dispatches halves the fill loop's per-batch dispatch overhead."""
    idx = masked_assign(X, seg_bin, centers, center_bin, valid, n_bins=n_bins)
    return minibatch_update(centers, counts, X, w, idx)


@partial(jax.jit, static_argnames=("k",))
def seed_bin(key, X, w, k):
    """Fused device seeding for one WE bin: weighted k-means++ -> 5 Lloyd
    sweeps -> final assignment -> per-center weight sums, in ONE dispatch
    with ONE downloadable (k, d+1) result (centers | wsum column).

    The separate calls cost ~4 dispatches plus two blocking downloads per
    bin. Identical ops to the separate kmeans_plusplus/lloyd/assign_flat/
    segment_sum calls (nested jitted calls inline).
    """
    init = kmeans_plusplus(key, X, w, k)
    cb = lloyd(X, w, init, n_iter=5)
    idx, _ = assign_flat(X, cb, jnp.ones(k, bool))
    wsum = jax.ops.segment_sum(w, idx, num_segments=k)
    return jnp.concatenate([cb, wsum[:, None]], axis=1)


@partial(jax.jit, static_argnames=("k",))
def seed_bins_batched(seeds, Xs, ws, k):
    """:func:`seed_bin` vmapped over every bin seeding in one batch: ONE
    compile, ONE dispatch, and ONE (B, k, d+1) download for all B bins.

    The per-bin route compiled a fresh ``seed_bin`` program for every
    distinct power-of-2 member count, so compiles dominated the seeding of
    a large build. Here all bins share one (B, P, d) zero-weight-padded
    shape, so the whole WE
    binning seeds with a single program. Keys derive from per-bin integer
    ``seeds`` inside the program (no per-bin host PRNGKey round trips).

    Padded rows (weight 0) are inert in every stage: k-means++ assigns
    them zero selection probability, Lloyd and the final weight sums add
    exact zeros. Like ``seed_bin``, results are the *device* seeding
    numerics family; the RNG realization additionally depends on the
    shared padded length P (``jax.random.choice`` draws over P rows), so
    centers differ from the per-bin-padded route -- both are valid
    clusterings of the same family.
    """

    def one(seed, Xb, wb):
        key = jax.random.PRNGKey(seed)
        init = kmeans_plusplus(key, Xb, wb, k)
        cb = lloyd(Xb, wb, init, n_iter=5)
        idx, _ = assign_flat(Xb, cb, jnp.ones(k, bool))
        wsum = jax.ops.segment_sum(wb, idx, num_segments=k)
        return jnp.concatenate([cb, wsum[:, None]], axis=1)

    return jax.vmap(one)(seeds, Xs, ws)


@partial(jax.jit, static_argnames=("n_bins", "window"))
def masked_minibatch_scan(centers, counts, X_all, eff_bin, w_all, init_mask,
                          starts, lengths, center_bin, valid,
                          n_bins=None, window=None):
    """A whole run of streaming minibatch updates in ONE device dispatch.

    Streaming stratified clustering dispatches one
    :func:`masked_minibatch_step` per accumulated batch, so a
    100-iteration build pays ~100 dispatches for work whose math is a pure
    sequential fold. This scans that fold on-device.

    Batch ``b`` is the row window ``[starts[b], starts[b] + lengths[b])``
    of the device-resident feature array ``X_all`` (shared with the
    discretization/flux paths -- no per-batch feature uploads). Rows are
    inert (weight 0, bin -1) when excluded from training (``eff_bin`` -1),
    in a not-yet-initialized bin (``init_mask``), or beyond the window
    length. Inert contributions are exact zeros (finite features times
    0.0f), so the fold is bitwise-identical to the per-batch
    ``masked_minibatch_step`` sequence over host-compacted live rows.

    ``w_all`` is None for unweighted training (live rows weigh 1.0).
    Each batch's assignment uses the previous batch's centers -- the
    MiniBatchKMeans streaming semantics of the reference
    (``stratified_clustering.py:205-212``).
    """
    def step(carry, xs):
        start, length = xs

        def real(cn):
            c, n = cn
            ridx = start + jnp.arange(window, dtype=starts.dtype)
            Xb = jnp.take(X_all, ridx, axis=0, mode="clip")
            bb = jnp.take(eff_bin, ridx, axis=0, mode="clip").astype(jnp.int32)
            ok = (
                (jnp.arange(window) < length)
                & (bb >= 0)
                & jnp.take(init_mask, jnp.maximum(bb, 0), axis=0, mode="clip")
            )
            bb = jnp.where(ok, bb, -1)
            if w_all is None:
                wb = ok.astype(jnp.float32)
            else:
                wb = jnp.where(
                    ok, jnp.take(w_all, ridx, axis=0, mode="clip"), 0.0
                )
            idx = masked_assign(Xb, bb, c, center_bin, valid, n_bins=n_bins)
            return minibatch_update(c, n, Xb, wb, idx)

        # Zero-length batches (batch-count padding) are IDENTITY, not an
        # all-inert update: minibatch_update's (c*n + 0)/n round trip is not
        # bitwise-exact, and the per-batch sequence it must match skips
        # empty batches entirely
        return jax.lax.cond(length > 0, real, lambda cn: cn, carry), None

    (c, n), _ = jax.lax.scan(step, (centers, counts), (starts, lengths))
    return c, n


def kmeans_fit(X, w, k, seed=0, n_iter=50, minibatch=False, batch_size=4096):
    """Host-orchestrated full fit: k-means++ seeding then Lloyd (or minibatch).

    Returns (centers, assignments) as numpy arrays. Deterministic given seed.
    """
    X = jnp.asarray(X, jnp.float32)
    w = jnp.asarray(w, jnp.float32) if w is not None else jnp.ones(X.shape[0], jnp.float32)
    key = jax.random.PRNGKey(seed)

    centers = kmeans_plusplus(key, X, w, k)
    if not minibatch or X.shape[0] <= batch_size:
        centers = lloyd(X, w, centers, n_iter=n_iter)
    else:
        counts = jnp.zeros(k, jnp.float32)
        valid = jnp.ones(k, bool)
        for start in range(0, X.shape[0], batch_size):
            xb = X[start : start + batch_size]
            wb = w[start : start + batch_size]
            idx, _ = assign_flat(xb, centers, valid)
            centers, counts = minibatch_update(centers, counts, xb, wb, idx)
    idx, _ = assign_flat(X, centers, jnp.ones(k, bool))
    return np.asarray(centers), np.asarray(idx)
