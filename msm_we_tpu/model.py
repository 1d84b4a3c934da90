"""modelWE facade: the reference-compatible haMSM model object.

Capability parity with the reference ``msm_we/msm_we.py`` ``modelWE`` (mixin
composite of data/dimensionality/clustering/fluxmatrix/analysis/plotting,
``msm_we.py:35-42``) and its attribute surface (``pSS``, ``Tmatrix``,
``fluxMatrix``, ``fluxMatrixRaw``, ``JtargetSS``, ``targetRMSD_centers``,
``dtrajs``, ``pair_dtrajs``, ``cluster_structures``, ``indBasis``,
``indTargets``, ``nBins``, ...).

Re-design (SURVEY.md section 7): instead of Ray task fan-out and fork
subprocesses, the engine
* ingests west.h5 once into cached host index arrays (data.WEDataset),
* featurizes + reduces all iterations into small device-resident feature
  arrays,
* discretizes every segment pair in one masked-distance matmul
  (ops.stratified), and
* accumulates the flux matrix with one jitted segment-sum
  (parallel.sharded._discretize_and_flux on device; f64 host bincount for
  the parity path).

The analysis tail (transition matrix, steady state, committors) runs in
float64 on the host for numerical parity (ops.linalg).

``use_ray`` / ``streaming`` / ``progress_bar`` keyword arguments are accepted
for API compatibility and ignored where the redesign makes them moot.
"""
from __future__ import annotations

from copy import deepcopy

import numpy as np

from ._logging import ProgressBar, log  # noqa: F401
from . import bootstrap as _bootstrap
from . import cleaning as _cleaning
from . import discretization as _discretization
from . import fluxmatrix as _fluxmatrix
from .binning import find_nearest_bin
from .data.westh5 import WEDataset
# Re-exported for backward compatibility (tests and old pickles import
# these from msm_we_tpu.model; the implementations live in features.py)
from .features import (  # noqa: F401
    FeatureSet,
    StreamingReducer,
    _device_parent_from_child,
    _feat_parent_rows,
    _featureset_unpickle,
    _id_columns_to_host,
    _pad_rows_to,
    _parent_gather_fn,
    device_row_feats as _device_row_feats_impl,
)
from .ops import linalg
from .ops.kmeans import kmeans_fit
from .ops.pca import (
    IdentityCoordinates,
    MomentAccumulator,
    PairMomentAccumulator,
)
from .ops.stratified import StratifiedKmeans

SUPPORTED_DIMREDUCE = ["none", "pca", "vamp", "tica", "batch-pca"]


def default_process_coordinates(coords):
    """Default featurization: flatten (n, atoms, 3) -> (n, atoms*3).

    The reference requires the user to monkey-patch ``processCoordinates``
    (``docs/usage.rst:41-60``); here a sane default exists and a user function
    can be passed to ``initialize`` or assigned as an attribute.
    """
    coords = np.asarray(coords)
    return coords.reshape(coords.shape[0], -1)


class _BinModelView:
    """Per-bin compatibility view with a ``cluster_centers_`` attribute."""

    def __init__(self, strat: StratifiedKmeans, bin_idx: int):
        self._strat = strat
        self._bin = bin_idx

    @property
    def cluster_centers_(self):
        return self._strat.centers_of_bin(self._bin)


class StratifiedClustersShim:
    """API-compatible stand-in for the reference ``StratifiedClusters``.

    Exposes ``cluster_models`` (per-bin views), ``we_remap``, ``bin_mapper``,
    ``predict`` with the reference's ``toggle``/``processing_from`` flip-flop
    (``stratified_clustering.py:101-212``), backed by the flattened
    :class:`~msm_we_tpu.ops.stratified.StratifiedKmeans` bank.
    """

    def __init__(self, bin_mapper, model, strat: StratifiedKmeans):
        self.bin_mapper = bin_mapper
        self.model = model
        self.strat = strat
        self.n_clusters_per_bin = strat.k
        self.processing_from = False
        self.toggle = False
        self.target_bins = set()
        self.basis_bins = set()

    @property
    def cluster_models(self):
        return [
            _BinModelView(self.strat, b) if self.strat.initialized[b] else object()
            for b in range(self.strat.n_bins)
        ]

    @property
    def we_remap(self):
        return {i: int(v) for i, v in enumerate(self.strat.we_remap)}

    @property
    def n_total_clusters(self):
        return self.strat.n_total_clusters

    def predict(self, coords):
        """Reference-compatible predict: bins from the model's pcoord lists.

        ``processing_from`` selects pcoord0List (parents) vs pcoord1List
        (children); ``toggle`` alternates after each call (fluxmatrix mode).
        """
        model = self.model
        pcoords = model.pcoord0List if self.processing_from else model.pcoord1List
        we_bins = self.bin_mapper.assign(pcoords)
        is_target = model.is_WE_target(pcoords)
        is_basis = model.is_WE_basis(pcoords)
        # The reference records REMAPPED bins (stratified_clustering.py:135,
        # 163-169: we_remap is applied before target_bins/basis_bins.add)
        remapped = self.strat.we_remap[we_bins]
        self.target_bins.update(np.unique(remapped[is_target]).tolist())
        self.basis_bins.update(np.unique(remapped[is_basis]).tolist())
        result = self.strat.predict(
            np.asarray(coords), we_bins, is_basis=is_basis, is_target=is_target
        )
        if self.toggle:
            self.processing_from = not self.processing_from
        return result


class _AggregateClustersShim:
    """Compatibility wrapper for aggregate (non-stratified) k-means."""

    def __init__(self, centers):
        self.cluster_centers_ = np.asarray(centers)

    def predict(self, X):
        from .ops.kmeans import assign_flat
        import jax.numpy as jnp

        idx, _ = assign_flat(
            jnp.asarray(np.asarray(X, np.float32)),
            jnp.asarray(self.cluster_centers_.astype(np.float32)),
            jnp.ones(len(self.cluster_centers_), bool),
        )
        return np.asarray(idx)


# Compat alias: _check_live_centers moved to discretization.py
from .discretization import _check_live_centers  # noqa: F401,E402


class modelWE:
    """History-augmented Markov state model estimation from WE data."""

    # Force the fused device scatter+psum flux program even on one process
    # (where the host f64 bincount of the device ids is measured faster and
    # is the default -- get_fluxMatrix). Class-level so tests can pin the
    # device program for parity coverage.
    _force_device_flux = False

    class BlockValidationError(Exception):
        pass

    def __init__(self):
        self.modelName = None
        self.pcoord_ndim = None
        self.pcoord_len = None
        self.tau = None
        self.n_lag = 0

        self._basis_pcoord_bounds = None
        self._target_pcoord_bounds = None
        self.basis_bin_centers = None
        self.target_bin_centers = None
        # Singular bin centers stay None -> NaN in sort arrays, which is what
        # pins basis/target to the last two positions of the pcoord sort
        # (reference behavior via None->NaN assignment, _clustering.py:1544-1545)
        self.target_bin_center = None
        self.basis_bin_center = None

        self.reference_structure = None
        self.reference_coord = None
        self.basis_coords = None
        self.nAtoms = None
        self.coord_ndim = 3

        self.coordinates = None
        self.ndim = None
        self.dimReduceMethod = None
        self.dedup_coordinates = "auto"

        self.n_clusters = None
        self.clusters = None
        self.clustering_method = None
        self.dtrajs = None
        self.pair_dtrajs = None
        self._parent_idx = None
        self._child_idx = None

        self.fluxMatrixRaw = None
        self.fluxMatrix = None
        self.Tmatrix = None
        self.pSS = None
        self.JtargetSS = None
        self.lagtime = None
        self.indBasis = None
        self.indTargets = None
        self.nBins = None
        self.q = None
        self.Jq = None
        self.J = None
        self.fit_parameters = {}
        self.slope_overcorrected = None

        self.targetRMSD_centers = None
        self.targetRMSD_minmax = None
        self.targetRMSD_all = None
        self.all_centers = None
        self.sorted_centers = None
        self.removed_clusters = []
        self.cluster_structures = None
        self.cluster_structure_weights = None
        self.structure_iteration_segments = None
        self.pcoord_cache = None

        self.validation_models = []
        self.validation_iterations = []
        self.post_cluster_model = None
        self.pre_discretization_model = None
        self.use_weights_in_clustering = False

        self.processCoordinates = default_process_coordinates

        # Engine internals
        self._dataset = None
        self._features = None  # dict with concatenated parent/child features
        self._strat = None
        self._bin_mapper = None
        self._mesh = None
        self._fluxMatrixParams = None
        self._cluster_seed = 0

    # ------------------------------------------------------------------ init
    def initialize(
        self,
        fileSpecifier,
        refPDBfile,
        modelName,
        basis_pcoord_bounds=None,
        target_pcoord_bounds=None,
        dim_reduce_method="none",
        tau=None,
        pcoord_ndim=1,
        auxpath="coord",
        _suppress_boundary_warning=False,
        use_weights_in_clustering=False,
        processCoordinates=None,
        dedup_coordinates="auto",
    ):
        """Set up the model (reference ``initialize``, ``msm_we.py:143-277``).

        ``fileSpecifier`` is a list of west.h5 paths, or a
        :class:`~msm_we_tpu.data.WEDataset` (e.g. ``WEDataset.from_arrays``
        over in-memory iterations) whose ``pcoord_ndim`` and ``auxpath``
        match the arguments here.

        ``dedup_coordinates``: WE trajectories are continuous -- a segment's
        frame-0 coordinates are a copy of its parent's final frame -- so
        parent features can be *gathered* from the previous iteration's child
        features instead of re-read and re-featurized (halving coordinate
        I/O and featurization work; the reference always does both twice).
        ``"auto"`` (default) verifies the invariant on the data (bitwise raw
        continuity + a sampled feature check that also catches
        non-row-independent featurizers) and falls back to the direct path
        on any mismatch; ``True`` forces the gather; ``False`` disables it.
        """
        if dedup_coordinates not in (True, False, "auto"):
            raise ValueError(
                "dedup_coordinates must be True, False, or 'auto', got "
                f"{dedup_coordinates!r}"
            )
        # Normalize np.bool_/1/0 (accepted by the `in` check above) to the
        # literals the featurization dispatch tests against.
        if dedup_coordinates != "auto":
            dedup_coordinates = bool(dedup_coordinates)
        self.dedup_coordinates = dedup_coordinates
        self.modelName = modelName
        dataset = None
        if isinstance(fileSpecifier, WEDataset):
            # An already-open dataset, e.g. WEDataset.from_arrays: in-memory
            # iterations in west.h5 layout, no file involved
            dataset = fileSpecifier
            if (dataset.pcoord_ndim, dataset.auxpath) != (pcoord_ndim, auxpath):
                raise ValueError(
                    f"dataset has pcoord_ndim={dataset.pcoord_ndim}, "
                    f"auxpath={dataset.auxpath!r}; initialize() was given "
                    f"pcoord_ndim={pcoord_ndim}, auxpath={auxpath!r}"
                )
            fileList = list(dataset.file_list)
        elif isinstance(fileSpecifier, str):
            fileList = fileSpecifier.split(" ")
            log.warning("HDF5 file paths provided as a string is deprecated; pass a list.")
        else:
            fileList = list(fileSpecifier)
        self.fileList = fileList
        self.n_data_files = len(fileList)
        self.pcoord_ndim = pcoord_ndim
        # Provisional; replaced by the file's actual frames-per-segment on
        # the first load_iter_data (reference ``_data.py:843``).
        self.pcoord_len = 2
        self.auxpath = auxpath

        if basis_pcoord_bounds is not None:
            self.basis_pcoord_bounds = basis_pcoord_bounds
        elif not _suppress_boundary_warning:
            log.warning("No basis coord bounds provided to initialize().")
        if target_pcoord_bounds is not None:
            self.target_pcoord_bounds = target_pcoord_bounds
        elif not _suppress_boundary_warning:
            log.warning("No target coord bounds provided to initialize().")

        if tau is None:
            log.warning("No tau provided, defaulting to 1.")
            tau = 1.0
        self.tau = float(tau)

        self.refPDBfile = refPDBfile
        self.set_topology(refPDBfile)

        if dim_reduce_method is None:
            log.warning("No dimensionality reduction method provided; defaulting to pca.")
            self.dimReduceMethod = "pca"
        else:
            assert dim_reduce_method in SUPPORTED_DIMREDUCE, (
                f"dim_reduce_method must be one of {SUPPORTED_DIMREDUCE}"
            )
            self.dimReduceMethod = dim_reduce_method

        if processCoordinates is not None:
            self.processCoordinates = processCoordinates

        self.use_weights_in_clustering = use_weights_in_clustering

        if dataset is None:
            dataset = WEDataset(fileList, pcoord_ndim=pcoord_ndim, auxpath=auxpath)
        self._dataset = dataset
        # Re-initialization must drop every cache derived from a previous
        # dataset (same invalidation load(h5_paths=...) performs): stale
        # features or cluster banks would silently describe the old data
        self._features = None
        self._raw_bins_cache = None
        self._strat = None
        self._bin_mapper = None
        self._fluxMatrixParams = None
        self.clusters = None
        self.dtrajs = None
        try:
            self.load_iter_data(1)
            # Probe the augmented coordinates too: the flag must reflect
            # auxdata presence, not just seg_index (reference msm_we.py:265-273
            # calls load_iter_coordinates0 here)
            self._dataset.iter_coord_pairs(1)
            self.coordsExist = True
        except KeyError:
            # Only the coords-not-written-yet case is benign (reference
            # msm_we.py:270); anything else should surface loudly
            if not _suppress_boundary_warning:
                log.warning("Model initialized, but coordinates do not exist yet.")
            self.coordsExist = False

    # ------------------------------------------------------- bounds & states
    @property
    def basis_pcoord_bounds(self):
        return self._basis_pcoord_bounds

    @basis_pcoord_bounds.setter
    def basis_pcoord_bounds(self, bounds):
        self._basis_pcoord_bounds = self._check_bounds(bounds)
        self.basis_bin_centers = self._bin_centers_of_bounds(self._basis_pcoord_bounds)
        self._invalidate_pcoord_caches()

    @property
    def target_pcoord_bounds(self):
        return self._target_pcoord_bounds

    @target_pcoord_bounds.setter
    def target_pcoord_bounds(self, bounds):
        self._target_pcoord_bounds = self._check_bounds(bounds)
        self.target_bin_centers = self._bin_centers_of_bounds(self._target_pcoord_bounds)
        self._invalidate_pcoord_caches()

    # Deprecated 1-D aliases (reference msm_we.py:279-298,365-387)
    @property
    def WEbasisp1_bounds(self):
        return self.basis_pcoord_bounds

    @WEbasisp1_bounds.setter
    def WEbasisp1_bounds(self, bounds):
        self.basis_pcoord_bounds = bounds

    @property
    def WEtargetp1_bounds(self):
        return self.target_pcoord_bounds

    @WEtargetp1_bounds.setter
    def WEtargetp1_bounds(self, bounds):
        self.target_pcoord_bounds = bounds

    def _check_bounds(self, bounds):
        bounds = np.array(bounds, dtype=float)
        if bounds.ndim == 1:
            log.warning("1-D boundaries should be [[lower, upper]]; converting.")
            bounds = bounds.reshape(1, 2)
        assert bounds.shape == (self.pcoord_ndim, 2), (
            f"Shape of bounds was {bounds.shape}, should've been "
            f"({self.pcoord_ndim}, 2)"
        )
        assert np.all(bounds[:, 0] < bounds[:, 1]), (
            "A boundary has a lower bound larger than its upper bound"
        )
        return bounds

    @staticmethod
    def _bin_centers_of_bounds(bounds):
        """Per-dim bin center: mean of finite bounds, else the finite one."""
        centers = np.full(len(bounds), np.nan)
        for i, (lo, hi) in enumerate(bounds):
            if np.isfinite(lo) and np.isfinite(hi):
                centers[i] = 0.5 * (lo + hi)
            else:
                centers[i] = lo if np.isfinite(lo) else hi
        return centers

    def _in_bounds(self, pcoords, bounds):
        from .utils import pcoord_in_bounds

        return pcoord_in_bounds(pcoords, bounds[: self.pcoord_ndim])

    def is_WE_basis(self, pcoords):
        """Segments whose pcoords lie inside the basis bounds (open interval,
        reference ``msm_we.py:462-492``)."""
        return self._in_bounds(pcoords, self.basis_pcoord_bounds)

    def is_WE_target(self, pcoords):
        return self._in_bounds(pcoords, self.target_pcoord_bounds)

    def _pc_masks(self):
        """Basis/target membership of every segment's parent/child pcoord,
        cached on the current feature arrays: a full build consults the same
        four boolean masks from clustering, discretization, the flux build,
        and every cleaning pass. Invalidated when the bounds change
        (setters), the features are recomputed, or ``is_WE_basis``/
        ``is_WE_target`` are monkey-patched on the *instance* before the
        first consumer runs (the reference's supported override point)."""
        feats = self._featurize_all()
        cache = getattr(self, "_pc_masks_cache", None)
        if cache is not None and cache[0] is feats:
            return cache[1]
        masks = dict(
            basis_p=np.asarray(self.is_WE_basis(feats["pcoord0"]), dtype=bool),
            basis_c=np.asarray(self.is_WE_basis(feats["pcoord1"]), dtype=bool),
            target_p=np.asarray(self.is_WE_target(feats["pcoord0"]), dtype=bool),
            target_c=np.asarray(self.is_WE_target(feats["pcoord1"]), dtype=bool),
        )
        # Rows inside BOTH regions (overlapping bounds -- rare): the only
        # rows where the flux build's basis-wins override order differs
        # from the predict-time target-wins order baked into the dtrajs.
        # None when absent so consumers can skip the fixup entirely.
        for ov, a, b in (
            ("overlap_p", "basis_p", "target_p"),
            ("overlap_c", "basis_c", "target_c"),
        ):
            o = masks[a] & masks[b]
            masks[ov] = o if o.any() else None
        self._pc_masks_cache = (feats, masks)
        return masks

    # ------------------------------------------------------------- topology
    def set_topology(self, topology):
        """Reference ``set_topology`` (``msm_we.py:1011-1078``); mdtraj is
        optional -- a dict of coords/nAtoms/coord_ndim always works."""
        if isinstance(topology, dict):
            self.reference_coord = topology.get("coords")
            self.nAtoms = topology["nAtoms"]
            self.coord_ndim = topology["coord_ndim"]
            return
        if isinstance(topology, str):
            if topology.endswith("dat"):
                self.reference_coord = np.loadtxt(topology)
                self.nAtoms = 1
                self.coord_ndim = 3
                return
            import mdtraj as md

            if topology.endswith("prmtop"):
                struct = md.load_prmtop(topology)
                self.reference_structure = struct
                self.nAtoms = struct.n_atoms
                self.coord_ndim = 3
                return
            struct = md.load(topology)
            self.reference_structure = struct
            self.reference_coord = np.squeeze(struct._xyz)
            self.nAtoms = struct.topology.n_atoms
            self.coord_ndim = 3
            return
        # mdtraj Trajectory/Topology duck-typing
        if hasattr(topology, "_xyz"):
            self.reference_structure = topology
            self.reference_coord = np.squeeze(topology._xyz)
            self.nAtoms = topology.topology.n_atoms
            self.coord_ndim = 3
            return
        raise NotImplementedError("Unsupported topology")

    def set_basis(self, basis):
        if isinstance(basis, dict):
            self.basis_coords = basis["coords"]
            return
        if isinstance(basis, str):
            if basis.endswith("dat"):
                self.basis_coords = np.loadtxt(basis)
                return
            import mdtraj as md

            self.basis_coords = np.squeeze(md.load(basis)._xyz)
            return
        if hasattr(basis, "_xyz"):
            self.basis_coords = np.squeeze(basis._xyz)
            return
        raise NotImplementedError("Unsupported basis")

    # ----------------------------------------------------------------- data
    def get_iterations(self):
        """Populate maxIter / numSegments (reference ``_data.py:934-993``)."""
        self.numSegments = self._dataset.numSegments
        self.maxIter = self._dataset.maxIter

    def load_iter_data(self, n_iter):
        """Compat: expose the reference's per-iteration attributes."""
        d = self._dataset.iter_data(n_iter)
        if self._dataset.pcoord_len is not None:
            # Read from the file, as the reference does (``_data.py:843``)
            self.pcoord_len = self._dataset.pcoord_len
        self.n_iter = n_iter
        self.westList = d["west_idx"]
        self.segindList = d["seg_idx"]
        self.weightList = d["weights"]
        self.nSeg = d["n_segs"]
        self.pcoord0List = d["pcoord0"]
        self.pcoord1List = d["pcoord1"]
        if not hasattr(self, "seg_weights") or self.seg_weights is None:
            self.seg_weights = {}
        self.seg_weights[n_iter] = d["weights"]

    def get_iter_coordinates(self, iteration):
        """Final-frame coordinates of an iteration's segments (NaN dropped)."""
        self.load_iter_data(iteration)
        return self._dataset.iter_child_coords(iteration)

    @property
    def n_lag(self):
        return self._n_lag

    @n_lag.setter
    def n_lag(self, lag):
        """Any lag >= 0. The reference gates this to 0 (``msm_we.py:353-359``)
        even though it carries (unreachable) lag machinery; here lag > 0 is a
        supported extension (see ``WEDataset.iter_transition_pairs``)."""
        lag = int(lag)
        if lag < 0:
            raise ValueError(f"n_lag must be >= 0, got {lag}")
        if lag > 0:
            log.info(
                f"Using lag n_lag={lag} ({lag + 1} tau transitions); this "
                "extends the reference, which only supports n_lag=0."
            )
        self._n_lag = lag

    def get_transition_data_lag0(self):
        """Populate ``coordPairList``/``transitionWeights``/``departureWeights``
        for the currently loaded iteration (reference ``_data.py:254-320``)."""
        parent, child, weights = self._dataset.iter_coord_pairs(self.n_iter)
        self.coordPairList = np.stack([parent, child], axis=-1)
        self.transitionWeights = weights.copy()
        self.departureWeights = weights.copy()

    def get_seg_histories(self, n_hist):
        """Walk each current segment's ancestry ``n_hist`` iterations back.

        Populates ``seg_histories`` (segment indices; negative once a walker
        was recycled) and ``weight_histories``, as the reference does by
        re-reading seg_index chains (``_data.py:322-421``).
        """
        if n_hist > self.n_iter:
            log.warning(f"Too much history requested; reducing n_hist to {self.n_iter}")
            n_hist = self.n_iter
        self.n_hist = n_hist

        n_seg = self.nSeg
        seg_histories = np.zeros((n_seg, n_hist + 1), dtype=int)
        weight_histories = np.zeros((n_seg, n_hist))

        # Indices are positions in the *concatenated* per-iteration arrays
        # (globalized parent ids), so multi-file datasets walk correctly --
        # the reference instead stores file-local ids plus a westList to
        # re-match (``_data.py:785-795``). Each history step is one gather
        # over all segments (the reference walks one python h5 read per
        # segment per step, ``_data.py:322-421``).
        seg_histories[:, 0] = np.arange(n_seg)
        warped = np.zeros(n_seg, dtype=bool)
        for iH in range(1, n_hist + 1):
            iter_back = self.n_iter - iH + 1
            d = self._dataset.iter_data(iter_back)
            cur = seg_histories[:, iH - 1]
            # Recycled: the ancestry ends permanently here (the reference's
            # 'warped' latch, _data.py:392-398); without it the walk would
            # resume from segment 0's data
            warped |= cur < 0
            active = ~warped
            idx = cur[active]
            seg_histories[active, iH] = d["parent_ids_global"][idx]
            weight_histories[active, iH - 1] = d["weights"][idx]
        self.seg_histories = seg_histories[:, :-1].astype(int)
        self.weight_histories = weight_histories

    def get_traj_coordinates(self, from_iter, traj_length):
        """Reconstruct each current walker's continuous coordinate history.

        Walks ``traj_length`` iterations of ancestry back from ``from_iter``
        and collects each ancestor's final-frame coordinates; histories are
        truncated where a walker was recycled (parent id < 0). Populates
        ``self.trajSet`` with one (n_steps, n_atoms, 3) array per current
        segment (reference ``_data.py:761-806``).
        """
        if traj_length > from_iter:
            traj_length = from_iter - 1
            log.warning(f"Trajectory length too long: set to {traj_length}")
        self.load_iter_data(from_iter)
        self.get_seg_histories(traj_length)

        n_seg = self.nSeg
        # seg_histories[:, h] = segment index h iterations back (<0 = recycled)
        coords_by_iter = {}
        for h in range(traj_length):
            it = from_iter - h
            coords_by_iter[it] = self._dataset._iter_frame_block(it, -1)

        traj_set = []
        for iS in range(n_seg):
            frames = []
            for h in range(traj_length - 1, -1, -1):
                idx = self.seg_histories[iS, h] if h < self.seg_histories.shape[1] else -1
                if idx < 0:
                    frames = []  # recycled: history ends here
                    continue
                frames.append(coords_by_iter[from_iter - h][idx])
            traj_set.append(np.array(frames))
        self.trajSet = traj_set
        return traj_set

    def get_coordSet(self, last_iter, streaming=None, progress_bar=None):
        """Build ``pcoordSet`` (+ ``all_coords`` when not streaming).

        Reference ``_data.py:677-759``; streaming keeps only pcoords.
        """
        if streaming is None:
            streaming = True
        parts = []
        coords_parts = [] if not streaming else None
        for i in range(1, last_iter + 1):
            d = self._dataset.iter_data(i)
            p = d["pcoord1"].copy()
            if not streaming:
                child = self._dataset._iter_frame_block(i, -1)
                bad = np.isnan(child).any(axis=tuple(range(1, child.ndim)))
                p[bad] = np.nan
                coords_parts.append(child)
            parts.append(p)
        self.pcoordSet = np.concatenate(parts, axis=0)
        if not streaming:
            self.all_coords = np.concatenate(coords_parts, axis=0)
        self.first_iter = 1
        self.last_iter = last_iter

    # ------------------------------------------------- dimensionality reduce
    DEVICE_MOMENTS_MIN_DIM = 256
    """Feature dimensionality above which dimReduce accumulates per-batch
    moments on device (f32 matmuls, f64 Chan combine across batches) instead
    of host f64 numpy: the d x d second-moment matmul is the dominant cost of
    a large PCA fit. Below it, host f64 is exact and avoids a device round
    trip. The crossover is still to be measured on the GPU (ROADMAP)."""

    def dimReduce(
        self,
        first_iter=1,
        first_rough_iter=None,
        last_iter=None,
        rough_stride=10,
        fine_stride=1,
        variance_cutoff=0.95,
        use_weights=True,
        progress_bar=None,
        device_moments=None,
        n_components=None,
    ):
        """Fit the dimensionality-reduction transform (reference
        ``_dimensionality.py:110-345``).

        ``pca`` uses exact streamed moments (one pass; no rough pass needed --
        the covariance the reference approximates with two iPCA passes is
        computed exactly). ``tica``/``vamp`` fit from (parent, child) pairs
        with WE weights (weights unsupported for vamp, as in the reference).

        ``n_components`` (``pca`` only): keep exactly this many leading
        components instead of the ``variance_cutoff`` count.

        ``device_moments``: None (auto -- device when the feature dim is at
        least ``DEVICE_MOMENTS_MIN_DIM``), or True/False to force. Device
        moments run the per-batch second-moment matmuls in f32 on the
        accelerator, combined across batches in f64 (Chan); the covariance
        differs from the exact host path by ~batch-count * f32 eps.
        """
        if last_iter is None:
            last_iter = self.maxIter

        method = self.dimReduceMethod
        if n_components is not None and method != "pca":
            raise ValueError(
                f"n_components applies to dimReduceMethod 'pca', not {method!r}"
            )
        if method == "none":
            self.ndim = int(self.coord_ndim * self.nAtoms)
            self.coordinates = IdentityCoordinates()
            return

        def moment_dtype(n_features):
            if device_moments is None:
                use_dev = n_features >= self.DEVICE_MOMENTS_MIN_DIM
            else:
                use_dev = bool(device_moments)
            return np.float32 if use_dev else np.float64

        if method == "pca":
            # Stream one iteration at a time -- raw coordinates never
            # accumulate in host RAM (the accumulator's host f64 path is
            # plain numpy, so ragged per-iteration shapes cost nothing)
            acc = None
            for i in range(first_iter, last_iter, fine_stride):
                c = self._dataset.iter_child_coords(i)
                if not c.shape[0]:
                    continue
                feats = np.asarray(self.processCoordinates(c))
                if acc is None:
                    acc = MomentAccumulator(
                        feats.shape[1], dtype=moment_dtype(feats.shape[1])
                    )
                acc.add(feats)
            if acc is None:
                raise ValueError(
                    f"No usable coordinates in iterations "
                    f"[{first_iter}, {last_iter}) at stride {fine_stride}; "
                    "cannot fit the dimensionality reduction."
                )
            self.coordinates = acc.finalize(
                variance_cutoff=variance_cutoff, n_components=n_components
            )
            self.ndim = self.coordinates.n_components
            return

        if method in ("tica", "vamp", "batch-pca"):
            # Streamed per iteration, as above
            flat_acc = None
            pair_acc = None
            use_w = use_weights and method == "tica"
            for iteration in range(first_iter, last_iter, fine_stride):
                parent, child, weights = self._dataset.iter_coord_pairs(iteration)
                good = np.flatnonzero(
                    ~(
                        np.isnan(parent).any(axis=tuple(range(1, parent.ndim)))
                        | np.isnan(child).any(axis=tuple(range(1, child.ndim)))
                    )
                )
                if len(good) == 0:
                    continue
                f0 = np.asarray(self.processCoordinates(parent[good]))
                f1 = np.asarray(self.processCoordinates(child[good]))
                w = weights[good]

                if method == "batch-pca":
                    if flat_acc is None:
                        flat_acc = MomentAccumulator(
                            f0.shape[1], dtype=moment_dtype(f0.shape[1])
                        )
                    flat_acc.add(f0)
                    flat_acc.add(f1)
                else:
                    if pair_acc is None:
                        # Pair moments are per-batch centered with an f64
                        # Chan-style combine (see PairMomentAccumulator), so
                        # the f32 device path is as safe as the PCA one
                        pair_acc = PairMomentAccumulator(
                            f0.shape[1], dtype=moment_dtype(f0.shape[1])
                        )
                    pair_acc.add(f0, f1, w if use_w else None)

            if flat_acc is None and pair_acc is None:
                raise ValueError(
                    f"No usable coordinate pairs in iterations "
                    f"[{first_iter}, {last_iter}) at stride {fine_stride}; "
                    "cannot fit the dimensionality reduction."
                )
            if method == "batch-pca":
                self.coordinates = flat_acc.finalize(variance_cutoff=1.0)
                self.ndim = self.coordinates.n_components
            else:
                self.coordinates = pair_acc.finalize(
                    method=method, var_cutoff=variance_cutoff
                )
                self.ndim = self.coordinates.output_dimension
            return

        raise NotImplementedError(f"dimReduceMethod {method}")

    def reduceCoordinates(self, coords):
        """processCoordinates then the fitted transform (reference
        ``_dimensionality.py:36-67``)."""
        if self.dimReduceMethod in SUPPORTED_DIMREDUCE:
            return self.coordinates.transform(self.processCoordinates(coords))
        raise RuntimeError("dimReduceMethod undefined in reduceCoordinates")

    # ------------------------------------------------------------- features
    FEATURE_CHUNK = 8192
    """Frames per fixed-shape device batch. Featurization streams chunks of
    exactly this many frames (last chunk zero-padded), so XLA compiles the
    transform once regardless of how segment counts vary per iteration --
    the padded-batch discipline of SURVEY.md P4."""

    # Streaming chunk reducer: implementation in features.StreamingReducer
    # (alias kept -- docs and downstream code refer to
    # ``modelWE._StreamingReducer``)
    _StreamingReducer = StreamingReducer

    def _featurize_all(self, force=False):
        """Reduce every iteration's (parent, child) coords to features, once
        (engine: :func:`msm_we_tpu.features.featurize_all`)."""
        from .features import featurize_all

        return featurize_all(self, force=force)

    def _featurize_dedup(self, verify=True):
        """Featurize with the WE-continuity dedup (engine:
        :func:`msm_we_tpu.features.featurize_dedup`)."""
        from .features import featurize_dedup

        return featurize_dedup(self, verify=verify)

    # ------------------------------------------------------------ clustering
    def cluster_coordinates(
        self,
        n_clusters,
        streaming=False,
        first_cluster_iter=None,
        use_ray=False,
        stratified=True,
        iters_to_use=None,
        store_validation_model=False,
        progress_bar=None,
        random_state=None,
        **_cluster_args,
    ):
        """Cluster features (reference ``_clustering.py:142-195``)."""
        log.info(
            "Be aware: Number of cluster centers is an important parameter; "
            "check block-validation results over a range of cluster counts."
        )
        if random_state is not None:
            self._cluster_seed = int(random_state)
        if stratified:
            self.clustering_method = "stratified"
            self.cluster_stratified(
                n_clusters=n_clusters,
                first_cluster_iter=first_cluster_iter,
                iters_to_use=iters_to_use,
                progress_bar=progress_bar,
                **_cluster_args,
            )
        else:
            self.clustering_method = "aggregated"
            self.cluster_aggregated(
                n_clusters=n_clusters,
                first_cluster_iter=first_cluster_iter,
                iters_to_use=iters_to_use,
                **_cluster_args,
            )

        if store_validation_model:
            self.post_cluster_model = deepcopy(self)

    def _resolve_iters(self, iters_to_use, first_cluster_iter):
        if iters_to_use is not None and first_cluster_iter is not None:
            log.error(
                "Conflicting parameters -- iters_to_use OR first_cluster_iter, not both."
            )
        if iters_to_use is None:
            first = first_cluster_iter if first_cluster_iter is not None else 1
            iters_to_use = range(first, self.maxIter)
        return list(iters_to_use)

    def cluster_aggregated(
        self, n_clusters, first_cluster_iter=None, iters_to_use=None, **_cluster_args
    ):
        """Whole-dataset weighted k-means (reference ``cluster_aggregated``,
        ``_clustering.py:197-523``)."""
        iters_to_use = self._resolve_iters(iters_to_use, first_cluster_iter)
        self.n_clusters = n_clusters
        self.first_cluster_iter = iters_to_use[0]

        feats = self._featurize_all()
        # Bad-coordinate segments (weight zeroed by the NaN convention) are
        # excluded from training: their zero-filled features are garbage
        sel = np.isin(feats["iteration"], iters_to_use) & (feats["weights"] > 0)
        X = feats["child"][sel]
        w = (
            feats["weights"][sel]
            if self.use_weights_in_clustering
            else np.ones(int(sel.sum()))
        )
        centers, _ = kmeans_fit(X, w, n_clusters, seed=self._cluster_seed)
        self.clusters = _AggregateClustersShim(centers)
        # Re-clustering a previously stratified model must drop the old
        # stratified bank: the device flux path keys on self._strat and
        # would otherwise assign against the defunct per-bin centers
        self._strat = None
        self._bin_mapper = None

        # Discretize all iterations (children and parents)
        self._discretize_all_aggregated()

    def _discretize_all_aggregated(self):
        feats = self._featurize_all()
        child_idx = self.clusters.predict(feats["child"])
        parent_idx = self.clusters.predict(feats["parent"])
        self._store_dtrajs(parent_idx, child_idx)

    def cluster_stratified(
        self,
        n_clusters,
        streaming=True,
        first_cluster_iter=None,
        use_ray=True,
        bin_iteration=2,
        iters_to_use=None,
        user_bin_mapper=None,
        progress_bar=None,
        defer_discretization=False,
        scan_small_batches=False,
        **_cluster_args,
    ):
        """Per-WE-bin stratified clustering (reference ``cluster_stratified``
        ``_clustering.py:525-746`` and ``do_stratified_clustering`` ``:748-918``).

        Accumulates iterations until every seen WE bin has >= n_clusters
        segments (excluding basis/target segments), fits each bin's model,
        remaps never-filled bins to the nearest filled bin, then discretizes
        everything in one batched call.

        ``defer_discretization=True`` (mesh builds only) skips that final
        discretization: ``dtrajs`` stay ``None`` until the next
        ``get_fluxMatrix`` call materializes them -- at lag 0 on the device
        path as a free byproduct of the combined flux+ids program (one
        dispatch+sync instead of two), otherwise via
        ``launch_discretization``. Don't touch ``dtrajs``-derived state
        (``update_cluster_structures`` etc.) in the deferred window.

        ``scan_small_batches=True`` routes sub-``HOST_BATCH_THRESHOLD``
        no-seeding fill batches through the fused device scan as well
        (one dispatch for the whole fill loop instead of ~one host update
        per iteration). Opt-in because it switches those batches from the
        host-numpy to the device numerics family: centers differ in
        near-tie assignments and f32 rounding, so builds no longer match a
        default (host-family) build bitwise -- both are equally valid
        clusterings. Seeding batches keep the host family either way.
        """
        if user_bin_mapper is not None:
            bin_mapper = user_bin_mapper
        else:
            bin_mapper = self._load_bin_mapper_from_h5(bin_iteration)
        self._bin_mapper = bin_mapper
        self._raw_bins_cache = None

        iters_to_use = self._resolve_iters(iters_to_use, first_cluster_iter)
        # Stage-internal breakdown (see discretization.run_streaming_batches
        # for the fill-loop counters; MSM_WE_TPU_PROFILE_CLUSTERING=1 makes
        # dispatch timings blocking for attribution)
        import time as _time

        self._cluster_profile = _prof = {}
        _t0 = _time.perf_counter()
        feats = self._featurize_all()
        _prof["featurize_s"] = round(_time.perf_counter() - _t0, 4)

        strat = StratifiedKmeans(
            n_bins=bin_mapper.nbins,
            k_per_bin=n_clusters,
            n_features=feats["child"].shape[1],
            seed=self._cluster_seed,
        )

        all_filled = set()

        # Training bins come from *parent* pcoords; basis/target segments
        # are excluded (reference _clustering.py:846-885), as are
        # bad-coordinate segments (weight zeroed by the NaN convention --
        # their features are zero-filled garbage; the reference drops NaN
        # rows from training, _data.py:557-618). One vectorized pass over
        # all rows -- the per-iteration mask+assign loop this replaces was
        # ~0.15 s of a warm 100k clustering stage.
        masks = self._pc_masks()
        keep_all = ~(masks["target_p"] | masks["basis_p"])
        keep_all &= feats["weights"] > 0
        kept_rows_all = np.flatnonzero(keep_all)
        # Slice the cached full parent-bin assignment instead of digitizing
        # the kept rows again (launch_discretization needs the full arrays
        # right after this anyway). Kept rows all have weight > 0, so the
        # nan_to_num inside _raw_we_bins never changes their bin.
        kept_bins_all = self._raw_we_bins()[0][kept_rows_all]
        offsets = feats["offsets"]

        # Pass 1: build the batch plan (accumulate iterations until all seen
        # bins are filled; engine: discretization.build_batch_plan)
        _t0 = _time.perf_counter()
        batches, delegated = _discretization.build_batch_plan(
            bin_mapper, iters_to_use, n_clusters,
            kept_rows_all, kept_bins_all, offsets,
        )
        _prof["batch_plan_s"] = round(_time.perf_counter() - _t0, 4)

        _t0 = _time.perf_counter()
        self._run_streaming_batches(strat, feats, batches, delegated,
                                    bin_mapper, all_filled, iters_to_use,
                                    scan_small_batches=scan_small_batches)
        _prof["fill_total_s"] = round(_time.perf_counter() - _t0, 4)
        # The fill loop may leave the bank device-resident; start streaming
        # it to host now so the next host consumer (the discretization
        # fallback rows' predict) finds it already materialized instead of
        # paying two blocking round trips mid-flux-stage
        _t0 = _time.perf_counter()
        strat.start_host_sync()

        # Never-filled bins delegate to the nearest filled bin
        true_unfilled = np.setdiff1d(
            np.arange(bin_mapper.nbins), sorted(all_filled)
        )
        for ub in true_unfilled:
            remap = find_nearest_bin(bin_mapper, int(ub), sorted(all_filled))
            strat.set_remap(int(ub), remap)
            log.debug(f"Remapped {ub} to {remap}")
        _prof["sync_remap_s"] = round(_time.perf_counter() - _t0, 4)

        self._strat = strat
        if getattr(self, "_mesh", None) is not None:
            strat.use_mesh(self._mesh)
        self.clusters = StratifiedClustersShim(bin_mapper, self, strat)
        # Reference sets the *nominal* total here (``_clustering.py:742``);
        # never-visited clusters are cleaned away in organize_fluxMatrix
        self.n_clusters = n_clusters * bin_mapper.nbins

        if defer_discretization and self._mesh is not None:
            # build_analyze_model's device fast path: the next
            # get_fluxMatrix(0) runs ONE combined device program that emits
            # the flux matrix and these ids together (one dispatch+sync
            # instead of two). Clear any previous clustering's ids -- the
            # lazy-materialization guards key on `_parent_idx is None`, so
            # stale old-numbering ids would otherwise be read as current.
            # Other dtrajs consumers materialize via _ensure_discretized().
            self.dtrajs = None
            self.pair_dtrajs = None
            self._parent_idx = None
            self._child_idx = None
            return
        self.launch_discretization()

    def _run_streaming_batches(self, strat, feats, batches, delegated,
                               bin_mapper, all_filled, iters_to_use,
                               scan_small_batches=False):
        """Execute the streaming-clustering batch plan (engine:
        :func:`msm_we_tpu.discretization.run_streaming_batches`)."""
        return _discretization.run_streaming_batches(
            self, strat, feats, batches, delegated, bin_mapper, all_filled,
            iters_to_use, scan_small_batches=scan_small_batches,
        )

    def _load_bin_mapper_from_h5(self, bin_iteration):
        """Load a WESTPA bin mapper from the h5 (requires westpa); otherwise
        instruct the user to pass ``user_bin_mapper``."""
        try:
            import westpa.tools.binning  # noqa: F401
            import h5py

            with h5py.File(self.fileList[0], "r") as h5:
                mapper, _, _ = westpa.tools.binning.mapper_from_hdf5(
                    h5["bin_topologies"],
                    h5[f"iterations/iter_{bin_iteration:08d}"].attrs["binhash"],
                )
            return mapper
        except Exception as e:
            raise RuntimeError(
                "Could not load a bin mapper from the H5 file (westpa not "
                "installed, or no bin_topologies group). Pass user_bin_mapper= "
                "with a msm_we_tpu.binning.RectilinearBinMapper/VoronoiBinMapper."
            ) from e

    # --------------------------------------------------------- discretization
    def launch_discretization(self, progress_bar=None):
        """Discretize every iteration's parent+child features in one pass
        (engine: :func:`msm_we_tpu.discretization.launch_discretization`;
        replaces the reference's per-iteration Ray fan-out,
        ``_clustering.py:1144-1242``)."""
        return _discretization.launch_discretization(
            self, progress_bar=progress_bar
        )

    def _sharded_pair_discretize(self, strat, parent_bins, child_bins):
        """One sharded dispatch assigning parent AND child rows (engine:
        :func:`msm_we_tpu.discretization.sharded_pair_discretize`)."""
        return _discretization.sharded_pair_discretize(
            self, strat, parent_bins, child_bins
        )

    def _invalidate_pcoord_caches(self):
        """Drop the caches derived from the feature pcoord arrays (WE bin
        assignments, basis/target masks). The feature dict is treated as
        immutable by the build pipeline; call this after mutating
        ``_features['pcoord0']``/``'pcoord1'`` in place (tests do)."""
        self._raw_bins_cache = None
        self._pc_masks_cache = None
        # Device uploads derived from the masks/pcoords go stale with them
        # (the flux row cache holds basis/target masks; the p1 cache holds
        # pcoords for the device stats route)
        self._device_flux_row_cache = None
        self._device_p1_cache = None

    def _raw_we_bins(self):
        """Un-remapped WE bin of every segment's parent/child pcoord (cached:
        recomputed bin assignments were a per-cleaning-pass cost)."""
        if getattr(self, "_raw_bins_cache", None) is None:
            feats = self._featurize_all()
            self._raw_bins_cache = (
                self._bin_mapper.assign(np.nan_to_num(feats["pcoord0"])),
                self._bin_mapper.assign(np.nan_to_num(feats["pcoord1"])),
            )
        return self._raw_bins_cache

    def _ensure_discretized(self):
        """Materialize dtrajs if a ``defer_discretization=True`` clustering
        left them pending (every dtrajs consumer calls this; the deferred
        window normally ends inside ``get_fluxMatrix(0)``'s combined
        device program instead)."""
        if self._parent_idx is None and self.clusters is not None:
            self.launch_discretization()

    def _store_dtrajs(self, parent_idx, child_idx):
        feats = self._features
        offsets = feats["offsets"]
        self.dtrajs = [
            child_idx[offsets[i] : offsets[i + 1]] for i in range(len(offsets) - 1)
        ]
        # (n, 2) arrays, not lists of tuples: `list(zip(...))` materializes
        # one Python tuple per segment -- profiled at 35 s of a 74 s
        # 2M-segment build (twice: discretization + cleaning's re-run).
        # Rows still unpack as (parent, child) pairs for reference-style
        # consumers; np.asarray(pair_dtrajs[i]) is now free.
        self.pair_dtrajs = [
            np.stack(
                [parent_idx[offsets[i] : offsets[i + 1]],
                 child_idx[offsets[i] : offsets[i + 1]]],
                axis=1,
            )
            for i in range(len(offsets) - 1)
        ]
        self._parent_idx = parent_idx
        self._child_idx = child_idx

    # ------------------------------------------------------------ flux matrix
    def get_fluxMatrix(
        self,
        n_lag,
        first_iter=1,
        last_iter=None,
        iters_to_use=None,
        use_ray=False,
        result_batch_size=5,
        progress_bar=None,
    ):
        """Weighted flux matrix over iterations (engine:
        :func:`msm_we_tpu.fluxmatrix.get_flux_matrix`; reference
        ``get_fluxMatrix``, ``_fluxmatrix.py:166-345``)."""
        return _fluxmatrix.get_flux_matrix(
            self, n_lag,
            first_iter=first_iter, last_iter=last_iter,
            iters_to_use=iters_to_use, use_ray=use_ray,
            result_batch_size=result_batch_size, progress_bar=progress_bar,
        )

    def _device_f64_weights_ok(self, weights):
        """True when the device flux route can accumulate these WE weights
        without losing any: always with the default f64 accumulation, and
        inside f32's range with the opt-in f32 tier (engine:
        :func:`msm_we_tpu.fluxmatrix.device_f64_weights_ok`)."""
        return _fluxmatrix.device_f64_weights_ok(self, weights)

    def _device_flux_lag0(self, iters_to_use):
        """Fused mesh-sharded flux matrix: discretize + f64 scatter + psum
        (engine: :func:`msm_we_tpu.fluxmatrix.device_flux_lag0`)."""
        return _fluxmatrix.device_flux_lag0(self, iters_to_use)

    def organize_fluxMatrix(self, use_ray=False, progress_bar=None,
                            incremental=True, max_passes=10, **args):
        """Clean the flux matrix (reference ``organize_fluxMatrix``,
        ``_fluxmatrix.py:347-415``). ``incremental=False`` forces the
        reference-style full re-discretization per pass; ``max_passes``
        bounds the clean-until-fixpoint loop. Unknown kwargs warn instead
        of silently disappearing (the reference swallows **args)."""
        if args:
            log.warning(f"organize_fluxMatrix ignoring unknown options {sorted(args)}")
        if self.clustering_method == "stratified":
            self.organize_stratified(
                incremental=incremental, max_passes=max_passes
            )
        elif self.clustering_method == "aggregated":
            self.organize_aggregated_simple(
                incremental=incremental, max_passes=max_passes
            )
        else:
            raise RuntimeError(
                f"Unrecognized clustering_method ({self.clustering_method})"
            )

    def _organize_flux_cleaning(self, remove_and_rediscretize, max_passes=10,
                                host_flux=False):
        """Shared flux-matrix cleaning driver (engine:
        :func:`msm_we_tpu.cleaning.organize_flux_cleaning`)."""
        return _cleaning.organize_flux_cleaning(
            self, remove_and_rediscretize, max_passes=max_passes,
            host_flux=host_flux,
        )

    def organize_stratified(self, use_ray=False, progress_bar=None,
                            max_passes=10, incremental=True):
        """Stratified cleaning (engine:
        :func:`msm_we_tpu.cleaning.organize_stratified`; reference
        ``organize_stratified``, ``_clustering.py:920-1142``)."""
        return _cleaning.organize_stratified(
            self, max_passes=max_passes, incremental=incremental
        )

    def _incremental_rediscretize(self, strat, old_remap, old_global,
                                  old_total):
        """Patch the stored dtrajs after center removal/remap (engine:
        :func:`msm_we_tpu.cleaning.incremental_rediscretize`)."""
        return _cleaning.incremental_rediscretize(
            self, strat, old_remap, old_global, old_total
        )

    def _assign_rows_subset(self, strat, X, bins_eff):
        """Stratified assignment for a (usually small) row subset (engine:
        :func:`msm_we_tpu.cleaning.assign_rows_subset`)."""
        return _cleaning.assign_rows_subset(self, strat, X, bins_eff)

    def organize_aggregated_simple(self, max_passes=10, incremental=True):
        """Aggregate-path cleaning (engine:
        :func:`msm_we_tpu.cleaning.organize_aggregated_simple`; the
        reference's ``organize_aggregated`` is deprecated and raises --
        ``_fluxmatrix.py:452-454``)."""
        return _cleaning.organize_aggregated_simple(
            self, max_passes=max_passes, incremental=incremental
        )

    # ------------------------------------------------------- cluster centers
    def get_cluster_centers(self):
        """Mean/min/max child-pcoord per cluster; returns the pcoord-sort
        permutation (engine: :func:`msm_we_tpu.structures.get_cluster_centers`;
        reference ``_clustering.py:1528-1599``)."""
        from .structures import get_cluster_centers

        return get_cluster_centers(self)

    def update_sorted_cluster_centers(self):
        """Reference ``_clustering.py:1601-1611``."""
        log.info("Sorting bins, assuming that pcoord 0 is meaningful for sorting")
        bin_centers = self.targetRMSD_centers[:, 0].copy()
        bin_centers[self.indTargets] = self.target_bin_centers[0]
        bin_centers[self.indBasis] = self.basis_bin_centers[0]
        self.all_centers = bin_centers
        self.sorted_centers = np.argsort(bin_centers)

    def update_cluster_structures(self, build_pcoord_cache=False):
        """Map each cluster to its member structures, weights, and provenance
        (engine: :func:`msm_we_tpu.structures.update_cluster_structures`;
        reference ``_clustering.py:1398-1526``)."""
        from .structures import update_cluster_structures

        return update_cluster_structures(
            self, build_pcoord_cache=build_pcoord_cache
        )

    # -------------------------------------------------------------- analysis
    def get_Tmatrix(self):
        self.Tmatrix = linalg.tmatrix_from_flux(
            self.fluxMatrix, self.indTargets, self.indBasis, self.nBins
        )

    def get_eqTmatrix(self):
        self.Tmatrix = linalg.equilibrium_tmatrix_from_flux(
            self.fluxMatrix, self.indTargets, self.indBasis
        )

    def get_steady_state(self, flux_fractional_convergence=1e-4, max_iters=10):
        pSS, _flux = linalg.steady_state_refined(
            self.Tmatrix,
            self.indTargets,
            self.indBasis,
            self.nBins,
            self.tau * (self.n_lag + 1),
            flux_fractional_convergence=flux_fractional_convergence,
            max_iters=max_iters,
        )
        self.pSS = pSS

    def get_steady_state_algebraic(self, max_iters=1000, check_negative=True, set=True):
        pSS = linalg.steady_state_algebraic(
            self.Tmatrix, max_iters=max_iters, check_negative=check_negative
        )
        if set:
            self.pSS = pSS
        else:
            return pSS

    def get_steady_state_matrixpowers(self, conv):
        """Matrix-power steady state (reference ``_analysis.py:284-315``)."""
        max_iters = 10000
        Mt = self.Tmatrix.copy()
        dconv = 1.0e100
        N = 1
        pSS = np.mean(Mt, 0)
        pSSp = np.ones_like(pSS)
        while dconv > conv and N < max_iters:
            Mt = self.Tmatrix @ Mt
            N += 1
            if N % 10 == 0:
                pSS = np.mean(Mt, 0)
                pSS = pSS / pSS.sum()
                dconv = np.abs(pSS - pSSp).sum()
                pSSp = pSS.copy()
                self.pSS = pSS.copy()

    def get_steady_state_target_flux(self, pSS=None, _set=True):
        import scipy.sparse as sparse

        from .utils import is_connected

        sparse_mat = sparse.csr_matrix(self.Tmatrix)
        if not is_connected(sparse_mat, self.indBasis, self.indTargets, directed=True):
            log.critical(
                "There is no path from the basis to the target, so no MFPT can "
                "be calculated."
            )
            return -1

        if pSS is None:
            pSS = np.squeeze(np.asarray(self.pSS))
        lagtime = self.tau * (self.n_lag + 1)
        J = linalg.target_flux(
            np.asarray(self.Tmatrix), pSS, self.indTargets, self.nBins, lagtime
        )
        if _set:
            self.lagtime = lagtime
            self.JtargetSS = J
        else:
            return J

    def get_committor(self, conv=1e-5, max_iters=100_000):
        log.info(
            "Note: for steady-state WE data this is a 'pseudocommittor', not a "
            "true committor, as it comes from a one-way ensemble."
        )
        self.q = linalg.committor(
            self.fluxMatrix, self.indTargets, self.indBasis, self.nBins,
            conv=conv, max_iters=max_iters,
        )

    def get_backwards_committor(self, conv, max_iters=100_000):
        self.qm = linalg.backwards_committor(
            self.fluxMatrix, self.indTargets, self.indBasis, self.nBins, conv,
            max_iters=max_iters,
        )
        self.q = self.qm.copy()

    def bootstrap_target_flux(
        self,
        n_boot=200,
        seed=0,
        alpha=0.05,
        block_size=1,
        iters_to_use=None,
        flux_fractional_convergence=1e-4,
        max_iters=10,
        observables=("flux",),
    ):
        """Block-bootstrap confidence interval for ``JtargetSS`` over WE
        iterations (engine: :func:`msm_we_tpu.bootstrap.bootstrap_target_flux`;
        an extension -- the reference has only point estimates plus block
        cross-validation)."""
        return _bootstrap.bootstrap_target_flux(
            self, n_boot=n_boot, seed=seed, alpha=alpha,
            block_size=block_size, iters_to_use=iters_to_use,
            flux_fractional_convergence=flux_fractional_convergence,
            max_iters=max_iters, observables=observables,
        )

    def get_flux(self):
        """Net flux profile over pcoord-sorted states + overcorrection check
        (reference ``_analysis.py:386-466``)."""
        from scipy.stats import linregress

        centers = self.targetRMSD_centers[:, 0].copy()
        centers[self.indBasis] = self.basis_bin_centers[0]
        centers[self.indTargets] = self.target_bin_centers[0]
        order = np.argsort(centers)

        self.J = linalg.net_flux_profile(self.fluxMatrix, order)

        if self.all_centers is None:
            self.update_sorted_cluster_centers()

        slope, intercept, r_value, p_value, std_err = linregress(
            self.all_centers, self.J / self.tau
        )
        self.fit_parameters = {
            "slope": slope,
            "intercept": intercept,
            "r_value": r_value,
            "p_value": p_value,
            "std_err": std_err,
        }

        target_before_basis = bool(
            np.any(self.target_bin_centers < self.basis_bin_centers)
        )
        self.slope_overcorrected = (slope < 0) if target_before_basis else (slope > 0)
        if self.slope_overcorrected:
            log.warning(
                "Flux profile appears to be overcorrected: flux is higher near "
                "the target than the basis. Restarting may have driven the "
                "system past its true steady state; continue this WE run "
                "without restarting and let it relax."
            )

    def get_flux_committor(self):
        """Net flux profile over committor-sorted states (reference
        ``_analysis.py:468-501``)."""
        order = np.argsort(np.squeeze(1.0 - self.q))
        self.Jq = linalg.net_flux_profile(self.fluxMatrix, order) / self.tau

    def evolve_target_flux(self):
        """Reference ``_analysis.py:503-525``."""
        Mss = self.Tmatrix
        probTransient = self.probTransient
        nT = np.shape(probTransient)[0]
        Jtarget = np.zeros(nT)
        self.lagtime = self.tau * (self.n_lag + 1)
        ind_not_targets = np.setdiff1d(range(self.nBins), self.indTargets)
        JtargetTimes = np.zeros(nT)
        for iT in range(nT):
            Jt = float(
                np.sum(
                    probTransient[iT, ind_not_targets][:, None]
                    * Mss[np.ix_(ind_not_targets, np.asarray(self.indTargets))]
                )
            )
            Jtarget[iT] = Jt
            JtargetTimes[iT] = iT * self.nStore * self.lagtime
        self.Jtarget = Jtarget / self.lagtime
        self.JtargetTimes = JtargetTimes

    def get_implied_timescales(
        self, lags=(0, 1, 2), n_timescales=3, iters_to_use=None,
        drop_basis_target=True,
    ):
        """Implied-timescale lag test over WE lag windows.

        Builds the raw flux matrix at each ``n_lag`` in ``lags`` (the
        effective physical lag of an ``n_lag`` window is ``(n_lag+1)*tau``),
        drops the basis/target recycling states (their artificial recycling
        edge is not part of the physical relaxation spectrum), and converts
        the leading eigenvalue magnitudes of the row-normalized largest
        connected component to timescales. For dynamics that are Markovian
        in the cluster space the curves are flat in lag -- the standard MSM
        validation the reference cannot run (its lag machinery is gated,
        ``msm_we.py:353-359``).

        Returns ``(lag_times, timescales)`` with shapes ``(len(lags),)`` and
        ``(len(lags), n_timescales)``; also stored as
        ``self.implied_timescales``. The model's flux-matrix state is
        saved and restored, so this is safe to call on a built model.
        """
        from .ops.linalg import implied_timescales_from_flux

        fms, lag_times = self._lagged_flux_matrices(
            lags, iters_to_use, drop_basis_target
        )
        self.implied_timescales = implied_timescales_from_flux(
            fms, lag_times, n_timescales=n_timescales
        )
        return lag_times, self.implied_timescales

    def _lagged_flux_matrices(self, lags, iters_to_use, drop_basis_target):
        """Raw flux matrices at each ``n_lag`` in ``lags``, with the model's
        flux-matrix state saved and restored around the rebuilds."""
        saved = (
            getattr(self, "fluxMatrixRaw", None),
            self.n_lag,
            getattr(self, "_fluxMatrixParams", None),
            getattr(self, "errorWeight", None),
            getattr(self, "errorCount", None),
        )
        fms, lag_times = [], []
        try:
            for lag in lags:
                self.get_fluxMatrix(int(lag), iters_to_use=iters_to_use)
                fm = np.asarray(self.fluxMatrixRaw)
                if drop_basis_target:
                    n = self.n_clusters
                    fm = fm[:n, :n]
                fms.append(fm)
                lag_times.append((int(lag) + 1) * self.tau)
        finally:
            (self.fluxMatrixRaw, self.n_lag, self._fluxMatrixParams,
             self.errorWeight, self.errorCount) = saved
        return fms, np.asarray(lag_times, dtype=np.float64)

    def get_ck_test(self, lags=(0, 1, 2, 3), sets=None, iters_to_use=None):
        """Chapman-Kolmogorov test over WE lag windows.

        The base model is the ``lags[0]`` window (physical lag
        ``(lags[0]+1)*tau``); every later window's physical lag must be an
        integer multiple of it (the defaults give factors 1, 2, 3, 4).
        Compares set-residence probabilities of the directly estimated
        lagged models against the base model propagated
        (:func:`~msm_we_tpu.ops.linalg.chapman_kolmogorov_from_flux`);
        coinciding curves indicate Markovian dynamics in the cluster space.
        ``sets=None`` uses the 2-metastable split by the slowest mode's sign
        structure; an integer ``sets=n`` coarse-grains the base model into n
        metastable sets with PCCA+ (:func:`~msm_we_tpu.ops.linalg.pcca_sets`).
        Returns ``(lag_times, sets, predicted, estimated)``;
        stored as ``self.ck_test``. Extends the reference (lag gated off).
        """
        from .ops.linalg import chapman_kolmogorov_from_flux, pcca_sets

        fms, lag_times = self._lagged_flux_matrices(
            lags, iters_to_use, drop_basis_target=True
        )
        if isinstance(sets, bool):
            raise ValueError(
                "sets must be None (slowest-mode split), an integer PCCA+ "
                "set count, or explicit state-index arrays -- not a bool"
            )
        if isinstance(sets, (int, np.integer)):
            sets = pcca_sets(fms[0], int(sets))
        base = lag_times[0]
        factors = lag_times / base
        int_factors = np.rint(factors).astype(int)
        if not np.allclose(factors, int_factors):
            raise ValueError(
                f"CK test needs integer lag multiples of the base window; "
                f"got physical lags {lag_times} (base {base})"
            )
        sets, predicted, estimated = chapman_kolmogorov_from_flux(
            fms, int_factors, sets=sets
        )
        self.ck_test = (lag_times, sets, predicted, estimated)
        return self.ck_test

    # ------------------------------------------------------- block validation
    def do_block_validation(
        self,
        cross_validation_groups,
        cross_validation_blocks,
        use_ray=False,
        progress_bar=None,
    ):
        """Split iterations into blocks/groups and build independent models
        (reference ``msm_we.py:884-1009``)."""
        assert getattr(self, "post_cluster_model", None) is not None, (
            "Perform clustering with cluster_coordinates() before attempting "
            "block validation -- self.post_cluster_model is not set."
        )

        validation_models = [
            deepcopy(self.post_cluster_model) for _ in range(cross_validation_groups)
        ]
        iters_per_block = self.post_cluster_model.maxIter // cross_validation_blocks
        block_iterations = [
            [start, start + iters_per_block]
            for start in range(1, self.post_cluster_model.maxIter, iters_per_block)
        ]
        block_iterations[-1][-1] -= 1
        group_blocks = [
            range(start_idx, cross_validation_blocks, cross_validation_groups)
            for start_idx in range(cross_validation_groups)
        ]

        validation_iterations = []
        for group in range(cross_validation_groups):
            group_iterations = []
            for block in group_blocks[group]:
                group_iterations.extend(range(*block_iterations[block]))
            validation_iterations.append(group_iterations)

            try:
                _model = validation_models[group]
                _model.get_fluxMatrix(0, iters_to_use=validation_iterations[group])
                _model.organize_fluxMatrix()
                _model.get_Tmatrix()
                _model.get_steady_state()
                _model.get_steady_state_target_flux()
            except Exception as e:
                log.error("Error during block validation!")
                log.exception(e)
                raise modelWE.BlockValidationError(e)

        self.validation_iterations = validation_iterations
        self.validation_models = validation_models

    # ------------------------------------------------------------- pipeline
    def build_analyze_model(
        self,
        file_paths,
        ref_struct,
        modelName,
        basis_pcoord_bounds,
        target_pcoord_bounds,
        dimreduce_method,
        tau,
        n_clusters,
        ray_kwargs={},
        max_coord_iter=-1,
        stratified=True,
        streaming=True,
        use_ray=False,
        fluxmatrix_iters=[1, -1],
        fluxmatrix_iters_to_use=None,
        cross_validation_groups=2,
        cross_validation_blocks=4,
        show_live_display=True,
        allow_validation_failure=False,
        step_kwargs={},
        progress_bar=None,
        profile_dir=None,
        device_pipeline=False,
        dedup_coordinates="auto",
    ):
        """One-shot build + analysis (reference ``msm_we.py:588-882``).

        Each stage's wall-clock is recorded in ``self.stage_timings``
        (a :class:`~msm_we_tpu.tracing.StageTimer`); ``show_live_display``
        renders a rich Live step table as stages progress (the reference's
        ``new_table``/``do_step`` display, ``msm_we.py:529-586``); pass
        ``profile_dir`` to additionally capture a JAX profiler trace of the
        whole build.

        ``device_pipeline=True`` enables a device mesh over all visible chips
        (``enable_mesh``): discretization and the flux matrix then run as
        mesh-sharded programs (f32 assignment matmuls, f64 flux scatter +
        psum) with results identical to the host path. The analysis tail
        stays in host float64 (the SURVEY section 7 precision split).
        """
        from .tracing import StageTimer, live_stage_display, profile_trace

        model = self
        if device_pipeline and model._mesh is None:
            model.enable_mesh()
        timer = StageTimer()
        model.stage_timings = timer

        try:
            self._run_build_pipeline(
                model,
                timer,
                file_paths=file_paths,
                ref_struct=ref_struct,
                modelName=modelName,
                basis_pcoord_bounds=basis_pcoord_bounds,
                target_pcoord_bounds=target_pcoord_bounds,
                dimreduce_method=dimreduce_method,
                tau=tau,
                n_clusters=n_clusters,
                streaming=streaming,
                stratified=stratified,
                fluxmatrix_iters=fluxmatrix_iters,
                fluxmatrix_iters_to_use=fluxmatrix_iters_to_use,
                cross_validation_groups=cross_validation_groups,
                cross_validation_blocks=cross_validation_blocks,
                allow_validation_failure=allow_validation_failure,
                show_live_display=show_live_display,
                step_kwargs=step_kwargs,
                max_coord_iter=max_coord_iter,
                profile_dir=profile_dir,
                device_pipeline=device_pipeline,
                dedup_coordinates=dedup_coordinates,
            )
        finally:
            # Release cached read handles even when a stage raises: WESTPA
            # reopens the same west.h5 read-write after the plugin builds a
            # model, and an in-process 'r' handle makes that reopen fail
            # (HDF5 flag conflict). Later model reads lazily reopen.
            model.close_files()

        log.info("\n" + timer.report())
        return model

    def _run_build_pipeline(
        self,
        model,
        timer,
        *,
        file_paths,
        ref_struct,
        modelName,
        basis_pcoord_bounds,
        target_pcoord_bounds,
        dimreduce_method,
        tau,
        n_clusters,
        streaming,
        stratified,
        fluxmatrix_iters,
        fluxmatrix_iters_to_use,
        cross_validation_groups,
        cross_validation_blocks,
        allow_validation_failure,
        show_live_display,
        step_kwargs,
        max_coord_iter,
        profile_dir,
        device_pipeline,
        dedup_coordinates,
    ):
        from .tracing import live_stage_display, profile_trace

        with profile_trace(profile_dir), live_stage_display(
            timer, enabled=show_live_display
        ):
            with timer.stage("Model initialization"):
                model.initialize(
                    file_paths,
                    ref_struct,
                    modelName,
                    basis_pcoord_bounds=basis_pcoord_bounds,
                    target_pcoord_bounds=target_pcoord_bounds,
                    dim_reduce_method=dimreduce_method,
                    tau=tau,
                    **{
                        "dedup_coordinates": dedup_coordinates,
                        **step_kwargs.get("initialize", {}),
                    },
                )
            with timer.stage("Loading iterations"):
                model.get_iterations()
                timer.set_note(f"{model.maxIter} iterations")
            _max_coord_iter = (
                model.maxIter if max_coord_iter == -1 else max_coord_iter
            )
            # Read ahead on a daemon thread: per-iteration index data and
            # the frame blocks the featurizer consumes land in the
            # (budget-bounded) caches while the pipeline below does numpy
            # and device work, instead of each stage serializing behind
            # hundreds of small h5py calls. Also serves dimReduce's moment
            # pass + the clustering featurization from one read. The finally
            # guarantees the reader thread stops and its blocks are released
            # even when a stage raises (otherwise the daemon keeps issuing
            # h5 reads and pins the read handles close_files exists to free).
            model._dataset.start_prefetch(_max_coord_iter)
            try:
                with timer.stage("Loading coordinates"):
                    model.get_coordSet(_max_coord_iter)
                with timer.stage("Dimensionality reduction"):
                    model.dimReduce(**step_kwargs.get("dimReduce", {}))
                    timer.set_note(
                        f"method={model.dimReduceMethod}, ndim={model.ndim}"
                    )
                with timer.stage("Clustering"):
                    cluster_kwargs = dict(step_kwargs.get("clustering", {}))
                    if (
                        device_pipeline
                        and stratified
                        and cross_validation_groups == 0
                    ):
                        # The flux stage's combined device program materializes
                        # dtrajs as a byproduct -- skip the standalone
                        # discretization dispatch+sync here. (With validation
                        # on, post_cluster_model must snapshot materialized
                        # dtrajs, so keep the eager path.)
                        cluster_kwargs.setdefault("defer_discretization", True)
                    model.cluster_coordinates(
                        n_clusters=n_clusters,
                        streaming=streaming,
                        stratified=stratified,
                        store_validation_model=cross_validation_groups > 0,
                        **cluster_kwargs,
                    )
            finally:
                model._dataset.drop_block_cache()
            _fm_iters = list(fluxmatrix_iters)
            if _fm_iters[1] == -1:
                _fm_iters[1] = model.maxIter
            with timer.stage("Flux matrix"):
                model.get_fluxMatrix(
                    0,
                    first_iter=_fm_iters[0],
                    last_iter=_fm_iters[1],
                    iters_to_use=fluxmatrix_iters_to_use,
                    **step_kwargs.get("fluxmatrix", {}),
                )
            original_clusters = model.fluxMatrixRaw.shape[0]
            with timer.stage("Cleaning"):
                model.organize_fluxMatrix(**step_kwargs.get("organize", {}))
                timer.set_note(
                    f"{original_clusters} -> {model.fluxMatrix.shape[0]} clusters"
                )
            with timer.stage("Transition matrix"):
                model.get_Tmatrix()
            with timer.stage("Steady-state distribution"):
                model.get_steady_state()
            with timer.stage("Steady-state target flux"):
                model.get_steady_state_target_flux()
                timer.set_note(f"JtargetSS={model.JtargetSS:.2e}")

            if cross_validation_groups > 0:
                with timer.stage("Cross-validation"):
                    try:
                        model.do_block_validation(
                            cross_validation_groups=cross_validation_groups,
                            cross_validation_blocks=cross_validation_blocks,
                            **step_kwargs.get("block_validation", {}),
                        )
                    except Exception as e:
                        log.error(e)
                        if not allow_validation_failure:
                            raise

    def close_files(self):
        """Close any cached read-only h5 handles (they reopen lazily on the
        next read). Call before another writer opens the same west.h5 files
        in this process -- WESTPA's data manager, augmentation scripts."""
        if self._dataset is not None:
            self._dataset.drop_block_cache()
            self._dataset.close()

    # ---------------------------------------------------------------- meshes
    def enable_mesh(self, mesh=None):
        """Run discretization data-parallel over a device mesh.

        With no argument, builds a ('data', 'model') mesh over all visible
        devices (``parallel.make_mesh``). Results are identical to the
        single-device path; segments shard over 'data', the center bank over
        'model' (SURVEY.md P1's mesh replacement for the Ray fan-out).
        Call after ``cluster_coordinates`` or before -- the mesh attaches to
        the stratified bank when available.
        """
        from .parallel import make_mesh

        self._mesh = mesh if mesh is not None else make_mesh()
        self._dev_feats_cache = None  # device arrays are mesh-specific
        self._device_p1_cache = None
        self._device_flux_row_cache = None
        if self._strat is not None:
            self._strat.use_mesh(self._mesh)
        return self._mesh

    def _device_row_feats(self, need_parent=True):
        """Padded, P('data')-sharded device copies of the parent/child
        feature arrays (engine: :func:`msm_we_tpu.features.device_row_feats`)."""
        return _device_row_feats_impl(self, need_parent=need_parent)

    # ---------------------------------------------------------- checkpointing
    def __getstate__(self):
        # Device meshes and compiled steps are process-local; call
        # enable_mesh() again after load
        state = self.__dict__.copy()
        state["_mesh"] = None
        state["_dev_feats_cache"] = None  # device arrays are process-local
        state["_device_p1_cache"] = None
        state["_device_flux_row_cache"] = None
        state["_pc_masks_cache"] = None  # derived; rebuilt on demand
        state.pop("_flux_step_cache", None)  # legacy pickles
        return state

    def __deepcopy__(self, memo):
        # __getstate__ also governs deepcopy, which would silently strip the
        # mesh from validation-model copies; keep the live mesh attached
        import copy as _copy

        mesh = self._mesh
        cls = self.__class__
        new = cls.__new__(cls)
        memo[id(self)] = new
        new.__dict__.update(_copy.deepcopy(self.__getstate__(), memo))
        if mesh is not None:
            new.enable_mesh(mesh)
        return new

    def save(self, path):
        """Pickle the full model (the reference's checkpoint format:
        ``restart_driver.py:1139-1143``, ``run_msmWE_flux.py:148-162``)."""
        import pickle

        with open(path, "wb") as fp:
            pickle.dump(self, fp, protocol=4)
        log.info(f"Model saved to {path}")

    @classmethod
    def load(cls, path, h5_paths=None):
        """Unpickle a model; optionally re-anchor its west.h5 paths.

        ``h5_paths`` replaces ``fileList`` and re-opens the dataset -- the
        moved-data workaround the reference test fixtures perform by rewriting
        pickled absolute paths (``tests/fixtures/hamsms.py:132-148``).
        """
        import pickle

        with open(path, "rb") as fp:
            model = pickle.load(fp)
        if h5_paths is not None:
            model.fileList = list(h5_paths)
            model.n_data_files = len(model.fileList)
            model._dataset = WEDataset(
                model.fileList,
                pcoord_ndim=model.pcoord_ndim,
                auxpath=model.auxpath,
            )
            model._features = None  # cached features refer to the old files
            model._raw_bins_cache = None
        return model

    # -------------------------------------------------------------- plotting
    def plot_flux(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_flux(self, *args, **kwargs)

    def plot_flux_committor(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_flux_committor(self, *args, **kwargs)

    def plot_flux_committor_pcoordcolor(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_flux_committor_pcoordcolor(self, *args, **kwargs)

    def plot_committor(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_committor(self, *args, **kwargs)

    def get_coarse_flux_profile(self, *args, **kwargs):
        from . import plotting

        return plotting.get_coarse_flux_profile(self, *args, **kwargs)

    def plot_coarse_flux_profile(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_coarse_flux_profile(self, *args, **kwargs)

    def draw_basis_target_boundaries(self, ax, pcoord_to_use=0):
        from . import plotting

        return plotting.draw_basis_target_boundaries(self, ax, pcoord_to_use)

    def plot_implied_timescales(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_implied_timescales(self, *args, **kwargs)

    def plot_ck_test(self, *args, **kwargs):
        from . import plotting

        return plotting.plot_ck_test(self, *args, **kwargs)

    @staticmethod
    def print_pseudocommittor_warning():
        log.info(
            "Note: for steady-state WE data this is a 'pseudocommittor', not "
            "a true committor, as it comes from a one-way ensemble."
        )

    # ---------------------------------------------- reference-API compat shims
    @staticmethod
    def find_nearest_bin(bin_mapper, bin_idx, filled_bins):
        """Reference ``_clustering.py:1331-1396``; delegates to binning."""
        return find_nearest_bin(bin_mapper, bin_idx, filled_bins)

    def load_iter_coordinates(self):
        """Set ``cur_iter_coords`` to the current iteration's final-frame
        coordinates (reference ``_data.py:557-618``); NaN rows preserved."""
        self.cur_iter_coords = self._dataset._iter_frame_block(self.n_iter, -1)

    def load_iter_coordinates0(self):
        """Set ``cur_iter_coords`` to the iteration's *initial* coordinates
        (reference ``_data.py:620-645``)."""
        self.cur_iter_coords = self._dataset._iter_frame_block(self.n_iter, 0)

    def get_iter_fluxMatrix(self, n_iter):
        """Single-iteration flux matrix (engine:
        :func:`msm_we_tpu.fluxmatrix.get_iter_flux_matrix`; reference
        ``_fluxmatrix.py:21-72``)."""
        return _fluxmatrix.get_iter_flux_matrix(self, n_iter)

    def get_transition_data(self, n_lag):
        """Populate ``coordPairList``/``transitionWeights``/``departureWeights``
        at lag ``n_lag`` for the currently loaded iteration.

        Start structures come from the segment's ancestor ``n_lag``
        iterations back; recycled lineages substitute ``basis_coords``
        (``set_basis``). Exceeds the reference, whose lag>0 path is gated off
        (``msm_we.py:353-359``) and internally unreachable
        (``_data.py:48-252``).
        """
        if n_lag == 0:
            # Keep n_lag consistent with the data populated: downstream
            # lagtime math (tau * (n_lag + 1)) would otherwise keep a stale
            # lag from an earlier call and silently rescale rates
            self.n_lag = 0
            return self.get_transition_data_lag0()
        tp = self._dataset.iter_transition_pairs(
            self.n_iter, n_lag, basis_coords=self.basis_coords
        )
        self.n_lag = n_lag
        self.coordPairList = np.stack([tp["start"], tp["end"]], axis=-1)
        self.transitionWeights = tp["weights"]
        self.departureWeights = tp["departure_weights"]

    def get_iterations_iters(self, first_iter, last_iter):
        """Segment counts over an iteration range (reference ``_data.py:995-1040``).

        Metadata only: counts come from the scan index, no per-iteration I/O.
        """
        index = self._dataset._iter_index
        self.numSegments = np.array(
            [
                float(sum(n for _f, n in index[i]))
                for i in range(first_iter, last_iter + 1)
                if i in index
            ]
        )
        self.maxIter = last_iter

    def get_coordinates(self, first_iter, last_iter):
        """Reference ``_data.py:647-675`` (it warns 'not tested or supported')."""
        log.warning("This function is not tested or supported, use at your own risk!")
        self.first_iter = first_iter
        self.last_iter = last_iter
        blocks = []
        for i in range(first_iter, last_iter + 1):
            blocks.append(self._dataset._iter_frame_block(i, -1))
        self.all_coords = np.concatenate(blocks)

    def collect_iter_coordinates(self, **kwargs):
        """Augment the model's west.h5 files with segment coordinates.

        Delegates to :func:`msm_we_tpu.scripts.augment_west_h5` (the working
        generalization of the reference's AMBER-specific example,
        ``_data.py:423-529``, which hardcoded ``traj_segs/%06d/%06d`` +
        ``parent.rst7``/``seg.rst7`` — the same defaults used here, but for
        any mdtraj-loadable format). Topology defaults to the model's
        ``refPDBfile``; layout/filenames are overridable via kwargs
        (``seg_dir_format``, ``parent_filename``, ``child_filename``,
        ``auxpath``, ``overwrite``). Unlike the reference, this augments
        every complete iteration, not just ``self.n_iter``.

        Returns the total number of iterations augmented across files.
        """
        from .scripts.collect_coordinates import augment_west_h5

        log.warning(
            "collect_iter_coordinates assumes a WESTPA traj_segs/ directory "
            "layout -- be sure it matches your simulation output "
            "(reference `_data.py:441-444`)."
        )
        import os as _os

        topology = kwargs.pop("topology_path", getattr(self, "refPDBfile", None))
        if isinstance(topology, _os.PathLike):
            topology = _os.fspath(topology)
        if not isinstance(topology, str):
            raise ValueError(
                "collect_iter_coordinates needs a topology file path; the "
                "model was initialized with a non-path topology. Pass "
                "topology_path=..."
            )
        kwargs.setdefault("auxpath", self.auxpath)
        if self._dataset is not None:
            # Release cached read handles before opening in append mode
            self._dataset.close()
        total = 0
        for west_file in self.fileList:
            total += augment_west_h5(west_file, topology, **kwargs)
        return total

    def launch_ray_discretization(self, progress_bar=None):
        """Compat alias: discretization is one batched device call now."""
        return self.launch_discretization(progress_bar=progress_bar)

    def organize_aggregated(self, use_ray=False, **args):
        """The reference's organize_aggregated is deprecated and raises
        (``_fluxmatrix.py:452-454``); this delegates to the working SCC-based
        equivalent."""
        return self.organize_aggregated_simple()

    def check_display_overcorrection_warning(self, ax):
        from . import plotting

        return plotting._check_display_overcorrection_warning(self, ax)

    # ------------------------------------------------------------- misc compat
    @staticmethod
    def check_connect_ray():
        """No-op: Ray is replaced by single-program JAX (SURVEY.md P1)."""
        log.debug("Ray not required: parallelism is provided by JAX sharding.")

    def progress_disable(self):
        pass

    def progress_enable(self):
        pass

    # Manual live-table helpers (reference msm_we.py:529-586). The automated
    # pipeline display in build_analyze_model is driven by StageTimer; these
    # statics reproduce the reference's hand-driven table API for users who
    # compose their own pipelines.
    _TABLE_STEPS = (
        "Ray initialization",
        "Model initialization",
        "Loading iterations",
        "Loading coordinates",
        "Computing dimensionality reduction",
        "Clustering",
        "Flux matrix",
        "Cleaning",
        "Transition matrix",
        "Steady-state distribution",
        "Steady-state target flux",
        "Cross-validation",
    )

    @staticmethod
    def new_table():
        """Build a rich progress table with one row per pipeline step
        (reference ``msm_we.py:561-586``)."""
        from rich.table import Table

        table = Table(title="haMSM Progress")
        for column in ("Status", "Step", "Notes"):
            table.add_column(column)
        for step in modelWE._TABLE_STEPS:
            table.add_row(" [ ]", step, "")
        return table

    @staticmethod
    def set_note(table, row, text):
        """Set the Notes cell of a step row (reference ``msm_we.py:558-560``)."""
        table.columns[2]._cells[row] = text

    @staticmethod
    def do_step(table, row, step, args=(), kwargs=None, in_subprocess=False):
        """Run one pipeline step, updating its table row to running/ok/failed
        (reference ``msm_we.py:529-556``). ``in_subprocess`` is accepted for
        API parity and ignored: the fork-isolation workaround (SURVEY.md P2)
        is unnecessary in this design.
        """
        del in_subprocess
        step_text = table.columns[1]._cells[row]
        status, name = table.columns[0], table.columns[1]
        status._cells[row] = "[bold black][ [bold yellow]* [bold black]]"
        name._cells[row] = f"[bold black]{step_text}"
        try:
            result = step(*args, **(kwargs or {}))
        except Exception as e:
            status._cells[row] = "[bold black] [[bold red]x[bold black]]"
            name._cells[row] = f"[black]{step_text}"
            table.columns[2]._cells[row] = f"{getattr(e, 'message', repr(e))}"
            raise
        status._cells[row] = "[bold black] [[bold green]✓[bold black]]"
        name._cells[row] = f"[black]{step_text}"
        return result


# Module-level alias: the reference defines BlockValidationError at module
# scope (msm_we.py:60-61); keep both import paths working.
BlockValidationError = modelWE.BlockValidationError
