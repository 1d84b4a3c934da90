"""Streaming dimensionality reduction: PCA, weighted TICA, VAMP.

Parity targets: ``_hamsm/_dimensionality.py`` -- streaming IncrementalPCA with
a variance-cutoff component count (``:142-244``), deeptime TICA/VAMP fit from
(start, end) time-lagged pairs with WE weights (TICA only; weights are
unsupported for VAMP, ``:303-306``), batch PCA (``:296``), and the identity
``Coordinates`` stub (``:24-34``).

Re-design: the reference runs every partial_fit in a forked subprocess purely
to force memory release (``:174-186,220-227``). Here moments are accumulated
streamingly -- per-batch partial sums are computed on device (one matmul for
the second moment), accumulated in float64 on the host, and the
tiny (d x d) eigenproblems run in numpy. Exact PCA replaces iPCA: on the same
data the covariance matches (the reference's own regression test compares
covariances, ``test_msm_we.py:86-90``), without iPCA's order-dependent
approximation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._logging import log

__all__ = [
    "IdentityCoordinates",
    "PCAModel",
    "TICAModel",
    "MomentAccumulator",
    "PairMomentAccumulator",
]


_HI = jax.lax.Precision.HIGHEST


def _pad_batch_pow2(X, w, extra=None):
    """Pad a batch to the next power-of-2 rows with zero-weight padding.

    Streaming fits see ragged per-iteration batch sizes; padding keeps the
    set of shapes reaching the jitted kernels logarithmic instead of one
    (expensive) XLA compile per distinct segment count.
    Zero-weight rows contribute nothing to weighted moments/updates.
    ``extra``: optional 1-D int array padded with zeros alongside (e.g. WE
    bin ids). The single shared implementation -- stratified streaming
    imports it too.
    """
    n = len(X)
    target = 1 << max(n - 1, 1).bit_length()
    if target == n:
        return (X, w) if extra is None else (X, w, extra)
    pad = target - n
    X = np.concatenate([X, np.zeros((pad, X.shape[1]), X.dtype)])
    w = np.concatenate([w, np.zeros(pad, w.dtype)])
    if extra is None:
        return X, w
    extra = np.concatenate([extra, np.zeros(pad, extra.dtype)])
    return X, w, extra


@jax.jit
def _weighted_gram(Xc, w):
    """Weighted Gram matrix of *pre-centered* data: (Xc * w)^T @ Xc.

    Callers center in f64 on the host BEFORE the f32 cast (see
    ``_center_f64``): centering after the cast cannot recover the
    |offset| * 2^-24 quantization error for far-from-origin data.
    """
    return jnp.matmul((Xc * w[:, None]).T, Xc, precision=_HI)


@jax.jit
def _weighted_cross_gram(X0c, Xtc, w):
    """Weighted cross-Gram of two pre-centered blocks."""
    return jnp.matmul((X0c * w[:, None]).T, Xtc, precision=_HI)


def _center_f64(X, w, ws):
    """(weighted batch mean, centered-then-f32 data), computed in f64.

    The f64 subtraction happens before the f32 cast so the representable
    precision tracks the data spread, not the offset from the origin.
    """
    X = np.asarray(X, np.float64)
    mean = (X * w[:, None]).sum(axis=0) / ws
    return mean, (X - mean[None, :]).astype(np.float32)


class IdentityCoordinates:
    """Identity transform -- the reference's ``Coordinates`` stub
    (``_dimensionality.py:24-34``)."""

    def transform(self, coords):
        return coords


# Reference import-path parity (``from ... import Coordinates``).
Coordinates = IdentityCoordinates


class MomentAccumulator:
    """Streaming first/second moments for PCA.

    Per-batch centered moments are combined across batches with Chan's
    pairwise update in float64. The per-batch computation runs in float64
    numpy by default (exact covariance parity); ``dtype=np.float32`` switches
    to the jitted device kernel for throughput runs, at the cost of a
    ~n_batch * eps covariance error.
    """

    def __init__(self, n_features, dtype=np.float64):
        self.n = 0.0  # total weight (== sample count when unweighted)
        self.n_samples = 0
        self.dtype = np.dtype(dtype)
        self.mean = np.zeros(n_features, dtype=np.float64)
        self.M2 = np.zeros((n_features, n_features), dtype=np.float64)

    def add(self, X, weights=None):
        if self.dtype == np.float64:
            X = np.asarray(X, np.float64)
            w = (
                np.asarray(weights, np.float64)
                if weights is not None
                else np.ones(X.shape[0])
            )
            ws = w.sum()
            if ws == 0.0:
                return
            mean_b = (X * w[:, None]).sum(axis=0) / ws
            Xc = X - mean_b[None, :]
            M2_b = (Xc * w[:, None]).T @ Xc
        else:
            w = (
                np.asarray(weights, np.float64)
                if weights is not None
                else np.ones(len(X), np.float64)
            )
            ws = float(w.sum())
            if ws == 0.0:
                return
            # Mean + centering in f64 on host (cheap, O(N d)); the d x d
            # second-moment matmul -- the actual work -- runs on device
            mean_b, Xc = _center_f64(X, w, ws)
            Xp, wp = _pad_batch_pow2(Xc, w.astype(np.float32))
            M2_b = np.asarray(
                _weighted_gram(jnp.asarray(Xp), jnp.asarray(wp)), np.float64
            )
        # Pairwise (Chan) combine of centered moments
        n_new = self.n + ws
        delta = mean_b - self.mean
        self.M2 += M2_b + np.outer(delta, delta) * (self.n * ws / n_new)
        self.mean += delta * (ws / n_new)
        self.n = n_new
        self.n_samples += len(X)

    def finalize(self, variance_cutoff=0.95, n_components=None):
        """Eigendecompose the covariance and return a :class:`PCAModel`.

        Unweighted accumulation divides by ``n_samples - 1`` (sklearn's
        ddof=1 convention); weighted accumulation divides by the total
        weight (the biased weighted covariance, the same convention as
        :class:`PairMomentAccumulator`) -- ``n - 1`` would be meaningless
        for weights that sum to O(1) over thousands of samples.
        """
        n_samples = getattr(self, "n_samples", None)
        weighted = n_samples is not None and self.n != n_samples
        if weighted:
            assert self.n > 0 and n_samples > 1, "Need more than one sample for PCA"
            denom = self.n
        else:
            assert self.n > 1, "Need more than one sample for PCA"
            denom = self.n - 1
        mean = self.mean
        cov = self.M2 / denom
        evals, evecs = np.linalg.eigh(cov)
        order = np.argsort(evals)[::-1]
        evals, evecs = np.maximum(evals[order], 0.0), evecs[:, order]

        if n_components is None:
            if variance_cutoff >= 1.0:
                # batch-pca parity: sklearn PCA(n_components=None) keeps every
                # component, including trailing zero-variance directions that
                # a cumulative-ratio test would drop on rank-deficient data
                n_components = len(evals)
            else:
                ratio = np.cumsum(evals) / np.maximum(evals.sum(), 1e-300)
                crossed = ratio >= variance_cutoff
                n_components = (
                    int(np.argmax(crossed) + 1) if crossed.any() else len(ratio)
                )
        log.debug(f"PCA keeping {n_components} components")
        return PCAModel(mean, evecs[:, :n_components].T, evals[:n_components], cov)


# Below this many FLOPs a projection runs in host numpy: a device round
# trip (transfer + dispatch + readback) dwarfs the matmul for small chunks.
# The value is still to be measured on the GPU (ROADMAP): at 900 raw dims a
# 30-component projection of an 8,192-row chunk (4.4e8 FLOP) runs on the
# device, a 2-component one (2.9e7 FLOP) on the host.
_DEVICE_TRANSFORM_MIN_FLOPS = 5e7


@jax.jit
def _project(flat, comp, offset=None):
    """The device projection ``flat @ comp - offset`` in f32 at
    ``Precision.HIGHEST``: one XLA module (``jit__project``) per chunk
    shape, which a profiler trace of a build names."""
    out = jnp.matmul(flat, comp, precision=_HI)
    return out if offset is None else out - offset


class PCAModel:
    """Fitted PCA transform: ``(x - mean) @ components.T``."""

    def __init__(self, mean, components, explained_variance, covariance=None):
        self.mean_ = np.asarray(mean)
        self.components_ = np.asarray(components)  # (n_components, d)
        self.explained_variance_ = np.asarray(explained_variance)
        self.covariance_ = covariance
        self.n_components = self.components_.shape[0]
        self._f32comp = self.components_.T.astype(np.float32)
        # (x - mu) @ C == x @ C - mu @ C: folding the centering into a
        # precomputed offset removes a full elementwise pass over the raw
        # matrix (at NTL9 scale the transform is HBM-bound, so that pass
        # costs as much as the matmul itself). BUT for far-from-origin data
        # (|mu| >> spread) the fold cancels catastrophically in f32 -- x@C
        # and mu@C are both huge, their difference small -- so it is only
        # used when the mean is modest relative to the data spread.
        self._offset = (self.mean_ @ self.components_.T.astype(np.float64)).astype(
            np.float32
        )
        total_var = float(np.sum(self.explained_variance_)) or 1.0
        self._fold_ok = float(self.mean_ @ self.mean_) <= 1e6 * total_var

    def _centered_f32(self, coords):
        # Far-from-origin data: center in f64 *before* the f32 cast, so the
        # representable precision tracks the data spread, not |mu| (casting
        # 1e6-offset coordinates to f32 directly loses ~|mu|*eps per value)
        flat = np.asarray(coords, np.float64).reshape(len(coords), -1)
        return (flat - self.mean_).astype(np.float32)

    def transform(self, coords):
        if not self._fold_ok:
            flat = self._centered_f32(coords)
            if 2.0 * flat.size * self.n_components < _DEVICE_TRANSFORM_MIN_FLOPS:
                return flat @ self._f32comp
            return np.asarray(_project(flat, self._f32comp))
        flat = np.asarray(coords, np.float32).reshape(len(coords), -1)
        if 2.0 * flat.size * self.n_components < _DEVICE_TRANSFORM_MIN_FLOPS:
            return flat @ self._f32comp - self._offset
        return np.asarray(_project(flat, self._f32comp, self._offset))


class PairMomentAccumulator:
    """Streaming lagged moments for TICA/VAMP from (start, end) pairs.

    Both dtype paths store *centered* moment sums (around the running
    means) and combine batches with the lagged-pair generalization of
    Chan's pairwise update, so the f32 device path is safe even for
    far-from-origin data -- the per-batch values entering f32 matmuls are
    centered and small, and all cross-batch arithmetic is f64.
    """

    def __init__(self, n_features, dtype=np.float64):
        self.n = 0.0
        self.dtype = np.dtype(dtype)
        self.mu0 = np.zeros(n_features, dtype=np.float64)
        self.mut = np.zeros(n_features, dtype=np.float64)
        self.C00 = np.zeros((n_features, n_features), dtype=np.float64)
        self.C0t = np.zeros((n_features, n_features), dtype=np.float64)
        self.Ctt = np.zeros((n_features, n_features), dtype=np.float64)

    def add(self, X0, Xt, weights=None):
        if self.dtype == np.float64:
            X0 = np.asarray(X0, np.float64)
            Xt = np.asarray(Xt, np.float64)
            w = (
                np.asarray(weights, np.float64)
                if weights is not None
                else np.ones(X0.shape[0])
            )
            ws = w.sum()
            if ws == 0.0:
                return
            mu0b = (X0 * w[:, None]).sum(axis=0) / ws
            mutb = (Xt * w[:, None]).sum(axis=0) / ws
            X0c = X0 - mu0b[None, :]
            Xtc = Xt - mutb[None, :]
            m00 = (X0c * w[:, None]).T @ X0c
            m0t = (X0c * w[:, None]).T @ Xtc
            mtt = (Xtc * w[:, None]).T @ Xtc
        else:
            w = (
                np.asarray(weights, np.float64)
                if weights is not None
                else np.ones(len(X0), np.float64)
            )
            ws = float(w.sum())
            if ws == 0.0:
                return
            # f64 host centering before the f32 cast (see _center_f64);
            # only the d x d matmuls run on device
            mu0b, X0c = _center_f64(X0, w, ws)
            mutb, Xtc = _center_f64(Xt, w, ws)
            X0p, wp = _pad_batch_pow2(X0c, w.astype(np.float32))
            Xtp, _ = _pad_batch_pow2(Xtc, w.astype(np.float32))
            X0j, Xtj, wj = jnp.asarray(X0p), jnp.asarray(Xtp), jnp.asarray(wp)
            m00 = np.asarray(_weighted_gram(X0j, wj), np.float64)
            m0t = np.asarray(_weighted_cross_gram(X0j, Xtj, wj), np.float64)
            mtt = np.asarray(_weighted_gram(Xtj, wj), np.float64)

        n_new = self.n + ws
        d0 = mu0b - self.mu0
        dt = mutb - self.mut
        f = self.n * ws / n_new
        self.C00 += m00 + f * np.outer(d0, d0)
        self.C0t += m0t + f * np.outer(d0, dt)
        self.Ctt += mtt + f * np.outer(dt, dt)
        self.mu0 += d0 * (ws / n_new)
        self.mut += dt * (ws / n_new)
        self.n = n_new

    def finalize(self, method="tica", var_cutoff=0.95, epsilon=1e-10):
        """Solve the (generalized) eigenproblem and return a :class:`TICAModel`.

        ``tica``: reversible (symmetrized) estimation with kinetic-map scaling.
        ``vamp``: non-reversible singular-value problem, kinetic-map scaling.
        """
        n = self.n
        mu0 = self.mu0
        mut = self.mut
        C00 = self.C00 / n
        C0t = self.C0t / n
        Ctt = self.Ctt / n

        def inv_sqrt(C):
            evals, evecs = np.linalg.eigh(C)
            emax = float(evals.max()) if len(evals) else 0.0
            if emax <= 0.0:
                raise ValueError(
                    "Covariance has no positive eigenvalues (constant "
                    "features?); cannot whiten for TICA/VAMP."
                )
            # Relative rank threshold only (the deeptime convention): an
            # absolute 1e-10 floor would silently discard EVERY component
            # for small-variance-scale data (e.g. unit choices putting
            # variances below 1e-10) and return an all-zero transform
            keep = evals > epsilon * emax
            return evecs[:, keep] @ np.diag(evals[keep] ** -0.5) @ evecs[:, keep].T

        if method == "tica":
            # Reversible symmetrized estimator, centered at the symmetrized
            # mean mu = (mu0 + mut)/2 (the deeptime convention the reference
            # inherits via ``_dimensionality.py:288-311``). Re-centering the
            # own-mean covariances at mu adds the +/- delta delta^T / 4
            # terms with delta = mu0 - mut.
            mu = 0.5 * (mu0 + mut)
            delta = mu0 - mut
            dd4 = 0.25 * np.outer(delta, delta)
            C00s = 0.5 * (C00 + Ctt) + dd4
            C0ts = 0.5 * (C0t + C0t.T) - dd4
            W = inv_sqrt(C00s)
            K = W @ C0ts @ W
            evals, evecs = np.linalg.eigh(0.5 * (K + K.T))
            order = np.argsort(np.abs(evals))[::-1]
            evals, evecs = evals[order], evecs[:, order]
            components = W @ evecs
            scales = evals  # kinetic map
            mean = mu
            kinetic_var = evals**2
        elif method == "vamp":
            W0 = inv_sqrt(C00)
            Wt = inv_sqrt(Ctt)
            K = W0 @ C0t @ Wt
            U, S, _Vt = np.linalg.svd(K)
            components = W0 @ U
            scales = S
            mean = mu0
            kinetic_var = S**2
        else:
            raise ValueError(f"Unknown method {method}")

        if var_cutoff >= 1.0:
            # keep everything; cumulative-ratio rounding can leave the last
            # entry at 0.999... and argmax-of-all-False would keep only 1
            n_comp = len(kinetic_var)
        else:
            ratio = np.cumsum(kinetic_var) / np.maximum(kinetic_var.sum(), 1e-300)
            crossed = ratio >= var_cutoff
            n_comp = int(np.argmax(crossed) + 1) if crossed.any() else len(ratio)
        n_comp = max(n_comp, 1)
        log.debug(f"{method} keeping {n_comp} components")
        return TICAModel(mean, components[:, :n_comp], scales[:n_comp])


class TICAModel:
    """Fitted TICA/VAMP transform with kinetic-map scaling."""

    def __init__(self, mean, components, scales):
        self.mean_ = np.asarray(mean)
        self.components_ = np.asarray(components)  # (d, n_components)
        self.scales_ = np.asarray(scales)
        self.output_dimension = self.components_.shape[1]
        self._f32comp = (self.components_ * self.scales_[None, :]).astype(np.float32)

    def transform(self, coords):
        # Center in f64 BEFORE the f32 cast (like the fit path and
        # PCAModel._centered_f32): casting far-from-origin raw coordinates
        # to f32 first would quantize away the spread
        flat = np.asarray(coords, np.float64).reshape(len(coords), -1)
        flat = (flat - self.mean_).astype(np.float32)
        if 2.0 * flat.size * self.output_dimension < _DEVICE_TRANSFORM_MIN_FLOPS:
            return flat @ self._f32comp
        return np.asarray(_project(flat, self._f32comp))
