"""Host-side WESTPA ``west.h5`` ingest.

Capability parity with the reference DataMixin (``_hamsm/_data.py``):
multi-file datasets, per-iteration ``seg_index`` (weights, parent ids),
``pcoord``, and augmented coordinates under ``auxdata/<auxpath>``; parent/child
coordinate pairs from frames 0 and -1 (``get_transition_data_lag0``,
``_data.py:254-320``); NaN coordinates zero the segment's transition weight
(``_data.py:303-313``). An iteration is usable only when the *next* iteration
also exists in the same file (the last iteration is incomplete,
``_data.py:859-866``).

Redesign: instead of a mutable god-object re-reading HDF5 per call, the reader
scans once, caches per-iteration index data (tiny), and streams coordinate
blocks on demand; the facade's feature pipeline packs them into fixed-size
device chunks (``modelWE._StreamingReducer``).

:meth:`WEDataset.from_arrays` serves the same methods from in-memory
per-iteration arrays in west.h5 layout; ``h5py`` is imported only by the
file-backed reader.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from .._logging import log

__all__ = ["WEDataset"]


def _iter_name(n):
    return f"iterations/iter_{int(n):08d}"


def _ll_read_full(did, dtype, shape=None):
    """Full-extent dataset read through h5py's low-level API.

    ``Dataset.__getitem__`` spends most of its time in Python-layer
    machinery (path/selection objects, compound-dtype reconstruction):
    measured 65 ms for 100 iterations of seg_index+pcoord vs 22 ms through
    ``DatasetID.read`` with the dtype memoized. h5py's internal lock (phil)
    still serializes the actual HDF5 call, so this stays safe under the
    prefetch thread."""
    from h5py import h5s

    out = np.empty(did.shape if shape is None else shape, dtype=dtype)
    if out.size:
        did.read(h5s.ALL, h5s.ALL, out)
    return out


class _ArrayDataset:
    """Read-only stand-in for an ``h5py.Dataset`` over an in-memory array.

    Every read returns a fresh array, as an HDF5 read does, so consumers that
    mutate what they read (the featurizer's ``nan_to_num(copy=False)``) never
    reach the source arrays."""

    def __init__(self, array):
        self._array = array

    shape = property(lambda self: self._array.shape)
    dtype = property(lambda self: self._array.dtype)
    nbytes = property(lambda self: self._array.nbytes)

    def __getitem__(self, key):
        return np.array(self._array[key])


# Continuity verdicts memoized across WEDataset instances, keyed by file
# identity (realpath, mtime_ns, size) + check parameters: restart marathons
# and repeated analyses rebuild models over unchanged files, and the sampled
# continuity check costs ~0.13 s per 100 iterations of pure re-verification.
_continuity_memo = {}


class WEDataset:
    """Immutable view over one or more west.h5 files.

    Parameters
    ----------
    file_list: list of paths to west.h5 files (segments of an iteration may be
        spread over several files; reference ``_data.py:271-277``).
    pcoord_ndim: number of progress-coordinate dimensions to load (extra dims
        in the file are ignored, matching ``_data.py:878-889``).
    auxpath: name of the augmented-coordinate dataset under ``auxdata/``.
    """

    def __init__(self, file_list, pcoord_ndim=1, auxpath="coord", *,
                 _groups=None):
        if isinstance(file_list, str):
            file_list = file_list.split(" ")
        self.file_list = list(file_list)
        self.pcoord_ndim = int(pcoord_ndim)
        self.auxpath = auxpath
        # In-memory source (from_arrays): one west.h5 iteration group per
        # entry, read as the single "file" 0; None for the file-backed reader
        self._groups = _groups

        self._iter_index = {}  # n_iter -> list of (file_idx, n_segs)
        self._scan()

        # Per-iteration caches populated lazily
        self._iter_data = {}
        self._pcoord_shape_warned = False
        # Number of pcoord frames per segment, read from the file on the
        # first pcoord load (reference ``_data.py:843``); None until then.
        self.pcoord_len = None
        # Read-only h5py handles, opened lazily and kept open: profiling a
        # warm 100-iteration build showed ~0.36 s (a third of the clustering
        # stage) spent in 856 h5py.File open/close cycles on the same file
        self._open_handles = {}
        self._coord_shape = None
        # h5py Dataset objects for auxdata/<auxpath>, keyed (file_idx,
        # n_iter): each `h5[".../auxdata/coord"]` resolves a 4-level path
        # (~1,200 resolutions = 0.15 s of a warm 100k build)
        self._dset_cache = {}
        # Optional whole-block read cache (enable_block_cache); None = off
        self._block_cache = None
        self._block_used = 0
        # Prefetch machinery (start_prefetch): a daemon reader thread fills
        # the iter_data/block caches ahead of the consumer. h5py serializes
        # actual HDF5 calls internally; this lock only guards OUR dict
        # caches and lazy handle creation (RLock: _read_frame_block ->
        # iter_data nests)
        self._io_lock = threading.RLock()
        self._prefetch_thread = None
        self._prefetch_stop = None
        self._block_consumed = set()
        self._block_shared = set()

    @classmethod
    def from_arrays(cls, iterations, pcoord_ndim=1, auxpath="coord"):
        """Dataset over in-memory iterations instead of west.h5 files.

        ``iterations`` is the per-iteration list of dicts that
        :func:`~msm_we_tpu.data.generate_trajectory_arrays` returns. They are
        laid out by the same function that writes them to west.h5
        (:func:`~msm_we_tpu.data.synthetic.west_iteration_layout`), and, as
        in a file, the last iteration is incomplete and unused. Every reader
        method behaves as it does on the equivalent file; ``file_list`` is
        empty.
        """
        from .synthetic import west_iteration_layout

        groups = [west_iteration_layout(d, auxpath) for d in iterations]
        return cls([], pcoord_ndim=pcoord_ndim, auxpath=auxpath, _groups=groups)

    def _h5(self, file_idx):
        """Persistent read-only handle for ``file_list[file_idx]``.

        Tradeoff: a cached handle holds the HDF5 shared read lock for the
        dataset's lifetime, so a WRITER -- another process's ``w_run`` or an
        augmentation script -- cannot open the same west.h5 read-write
        until :meth:`close` runs. In-process writer sites call it
        (``modelWE.close_files`` at build end, the kh pcoord writer, the
        optimization driver before ``open_backing``); for external writers,
        call ``model.close_files()`` first. (Opening with ``locking=False``
        instead conflicts with every default-locking open of the same file
        in this process, which is worse.)
        """
        import h5py

        with self._io_lock:
            h5 = self._open_handles.get(file_idx)
            if h5 is None or not h5.id.valid:
                h5 = h5py.File(self.file_list[file_idx], "r")
                self._open_handles[file_idx] = h5
            return h5

    def close(self):
        """Close any cached file handles (call before re-writing the files,
        e.g. augmentation scripts opening them in append mode)."""
        self.stop_prefetch()
        with self._io_lock:
            self._dset_cache = {}
            for h5 in self._open_handles.values():
                try:
                    h5.close()
                except Exception:
                    pass
            self._open_handles = {}

    def enable_block_cache(self, budget_bytes=None):
        """Cache whole-iteration frame blocks read by :meth:`_iter_frame_block`
        so back-to-back passes over the same frames (dimReduce's moment pass
        followed by featurization) hit memory instead of re-reading HDF5.

        Plain hits return a shared read-only view of the cached array; a
        consumer that will mutate the block in place (the featurizer's
        ``nan_to_num(copy=False)``) must pass ``consume=True`` to
        :meth:`_iter_frame_block`, which pops the entry (ownership
        transfer) so no other holder aliases it. Consumed pops are what
        bound peak memory to one pipeline's worth of blocks. Reads stop
        being cached once ``budget_bytes`` (default 512 MB, env
        ``MSM_WE_TPU_BLOCK_CACHE_MB``) is reached -- large datasets simply
        keep the previous streaming behavior.
        """
        if budget_bytes is None:
            import os

            budget_bytes = (
                int(os.environ.get("MSM_WE_TPU_BLOCK_CACHE_MB", 512)) << 20
            )
        with self._io_lock:
            self._block_cache = {}
            self._block_budget = int(budget_bytes)
            self._block_used = 0
            self._block_consumed = set()
            self._block_shared = set()

    def drop_block_cache(self):
        self.stop_prefetch()
        with self._io_lock:
            self._block_cache = None
            self._block_used = 0
            self._block_consumed = set()
            self._block_shared = set()

    def start_prefetch(self, last_iter, frames=(-1,)):
        """Read ahead on a daemon thread: per-iteration index data
        (:meth:`iter_data`) for iterations ``1..last_iter`` plus the frame
        blocks the dedup featurizer consumes (``1..last_iter-1``), landing
        in the (budget-bounded) caches before the pipeline asks for them.

        h5py serializes HDF5 calls through its own global lock, so the
        reads interleave safely with the consumer thread's; the win is that
        they overlap the consumer's *numpy/device* work (featurization,
        moment accumulation, fill dispatches) instead of serializing whole
        build stages behind ~500 small h5py calls. When the block budget
        fills, the reader idles until the consumer pops entries
        (``consume=True`` hand-over), bounding memory; blocks the consumer
        already took are never re-read. No-op if a prefetch is running."""
        if self._prefetch_thread is not None and self._prefetch_thread.is_alive():
            return
        if self._block_cache is None:
            self.enable_block_cache()
        stop = threading.Event()

        def run():
            try:
                # Phase 1: per-iteration index data only. get_coordSet (the
                # pipeline's first consumer) reads exactly this, in this
                # order -- interleaving the (much larger) block reads here
                # made that stage wait behind reads it doesn't need yet
                # (h5py's global lock serializes the two threads).
                for i in range(1, last_iter + 1):
                    if stop.is_set():
                        return
                    self.iter_data(i)
                # Phase 2: frame blocks for the featurizer passes.
                for i in range(1, last_iter):
                    if stop.is_set():
                        return
                    for f in frames:
                        key = (i, f)
                        with self._io_lock:
                            cache = self._block_cache
                            if (
                                cache is None
                                or key in cache
                                or key in self._block_consumed
                            ):
                                continue
                        # Backpressure: wait for a consumer pop instead of
                        # reading into a full cache (the read would be
                        # discarded and re-done by the consumer anyway)
                        est = self._block_nbytes_estimate()
                        if est > self._block_budget:
                            # A block that can never fit (even into an empty
                            # cache) must not stall the loop: skip caching it
                            # and keep prefetching iter_data for the
                            # remaining iterations -- the consumer streams
                            # such blocks itself, as before the cache existed
                            continue
                        skip = False
                        while not stop.is_set():
                            with self._io_lock:
                                if self._block_cache is None:
                                    return
                                # Re-check the key while waiting: the
                                # consumer may have read it directly (or
                                # consumed it) in the meantime -- keep
                                # moving rather than spinning on a block
                                # nobody needs anymore
                                if (
                                    key in self._block_cache
                                    or key in self._block_consumed
                                ):
                                    skip = True
                                    break
                                if self._block_used + est <= self._block_budget:
                                    break
                            time.sleep(0.002)
                        if skip:
                            continue
                        if stop.is_set():
                            return
                        block = self._read_frame_block(i, f)
                        with self._io_lock:
                            cache = self._block_cache
                            if (
                                cache is not None
                                and key not in cache
                                and key not in self._block_consumed
                                and self._block_used + block.nbytes
                                <= self._block_budget
                            ):
                                cache[key] = block
                                self._block_used += block.nbytes
            except Exception as e:  # reader failures surface at consume time
                log.debug(f"prefetch thread stopped early: {e}")

        self._prefetch_stop = stop
        self._prefetch_thread = threading.Thread(
            target=run, name="westh5-prefetch", daemon=True
        )
        self._prefetch_thread.start()

    def stop_prefetch(self):
        t, stop = self._prefetch_thread, self._prefetch_stop
        if stop is not None:
            stop.set()
        if t is not None and t.is_alive():
            t.join(timeout=10)
        self._prefetch_thread = None
        self._prefetch_stop = None

    def _block_nbytes_estimate(self):
        """Upper-bound size of one frame block (for prefetch backpressure).

        Uses the auxdata dataset's real itemsize (memoized): assuming 8
        bytes/element would double the estimate for the common f32 case and
        make the prefetcher refuse blocks that actually fit the budget."""
        n_atoms, coord_ndim = self.n_atoms_coord_ndim()
        itemsize = getattr(self, "_coord_itemsize", None)
        if itemsize is None:
            first = next(iter(self._iter_index))
            file_idx, _ = self._iter_index[first][0]
            itemsize = int(self._aux_dset(file_idx, first).dtype.itemsize)
            self._coord_itemsize = itemsize
        return int(self.max_segs) * int(n_atoms) * int(coord_ndim) * itemsize

    def _index_dtypes(self, file_idx, si_id, pc_id):
        """Memoized (seg_index, pcoord) numpy dtypes for one file.

        Reconstructing a compound dtype from HDF5 type metadata costs ~0.12 ms
        per call (12 ms of a 100-iteration index pass); one WESTPA run writes
        every iteration with the same dtypes, so resolve them once per file."""
        dtypes = getattr(self, "_index_dtype_memo", None)
        if dtypes is None:
            dtypes = self._index_dtype_memo = {}
        pair = dtypes.get(file_idx)
        if pair is None:
            import h5py

            pair = (
                h5py.Dataset(si_id).dtype,
                h5py.Dataset(pc_id).dtype,
            )
            dtypes[file_idx] = pair
        return pair

    def _aux_full(self, file_idx, n_iter):
        """Full-extent read of one iteration's ``auxdata/<auxpath>`` block
        through the low-level API.

        The read dtype is the one resolved for THIS (file, iteration) at
        ``_aux_dset`` cache-insert time -- a per-file memo would silently
        down-convert later iterations written with a wider dtype (f64 after
        f32, the mixed-dtype case ``_read_frame_block``'s multi-file path
        explicitly promotes for)."""
        dset = self._aux_dset(file_idx, n_iter)
        if isinstance(dset, _ArrayDataset):
            return dset[()]
        dtype = getattr(self, "_aux_dtype_memo", {}).get((file_idx, n_iter))
        if dtype is None:  # dset predates the memo (e.g. legacy pickle)
            dtype = dset.dtype
        return _ll_read_full(dset.id, dtype)

    def _aux_dset(self, file_idx, n_iter):
        """Cached ``auxdata/<auxpath>`` Dataset for one (file, iteration).

        The numpy dtype is resolved once here, at insert time (reconstructing
        it from HDF5 type metadata costs ~0.12 ms per call), keyed by the
        same (file, iteration) pair so mixed-dtype files stay exact."""
        key = (file_idx, n_iter)
        with self._io_lock:
            dset = self._dset_cache.get(key)
            if dset is None or not (
                isinstance(dset, _ArrayDataset) or dset.id.valid
            ):
                if self._groups is not None:
                    try:
                        dset = _ArrayDataset(
                            self._groups[n_iter - 1][f"auxdata/{self.auxpath}"]
                        )
                    except KeyError:
                        raise KeyError(
                            f"iteration {n_iter} has no auxdata/{self.auxpath}"
                        ) from None
                else:
                    dset = self._h5(file_idx)[
                        f"{_iter_name(n_iter)}/auxdata/{self.auxpath}"
                    ]
                assert dset.shape[1] > 1, (
                    "Augmented coords need at least start & end frames"
                )
                self._dset_cache[key] = dset
                if not hasattr(self, "_aux_dtype_memo"):
                    self._aux_dtype_memo = {}
                self._aux_dtype_memo[key] = dset.dtype
                if getattr(self, "_coord_itemsize", None) is None:
                    self._coord_itemsize = int(dset.dtype.itemsize)
            return dset

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_open_handles"] = {}  # h5py handles are process-local
        state["_dset_cache"] = {}
        state["_block_cache"] = None  # never pickle raw coordinate blocks
        state["_block_used"] = 0
        state["_block_consumed"] = set()
        state["_block_shared"] = set()
        state["_io_lock"] = None  # locks/threads are process-local
        state["_prefetch_thread"] = None
        state["_prefetch_stop"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        # Backfill attributes absent from legacy (pre-0.3.0) pickles
        if "_open_handles" not in state:
            self._open_handles = {}
        if "_coord_shape" not in state:
            self._coord_shape = None
        if "pcoord_len" not in state:
            self.pcoord_len = None
        if "_dset_cache" not in state:
            self._dset_cache = {}
        if "_block_cache" not in state:
            self._block_cache = None
            self._block_used = 0
        if "_groups" not in state:
            self._groups = None
        if not isinstance(getattr(self, "_io_lock", None), type(threading.RLock())):
            self._io_lock = threading.RLock()
        self._prefetch_thread = None
        self._prefetch_stop = None
        if not hasattr(self, "_block_consumed") or self._block_consumed is None:
            self._block_consumed = set()
        if not hasattr(self, "_block_shared") or self._block_shared is None:
            self._block_shared = set()

    # ------------------------------------------------------------------ scan
    def _scan(self):
        """Find every usable iteration and its segment counts per file.

        Opens each file exactly once and enumerates its iteration groups
        (the reference re-opens every file for every iteration,
        ``_data.py:955-989``).
        """
        # Per file: {n_iter: n_segs} for iterations whose successor also
        # exists in the same file (the last iteration is incomplete)
        if self._groups is not None:
            present_per_file = [{
                i + 1: len(g["seg_index"]) for i, g in enumerate(self._groups)
            }]
        else:
            import h5py

            present_per_file = []
            for path in self.file_list:
                present = {}
                with h5py.File(path, "r") as h5:
                    if "iterations" in h5:
                        for key in h5["iterations"]:
                            grp = h5["iterations"][key]
                            if "seg_index" in grp:
                                present[int(key.split("_")[1])] = (
                                    grp["seg_index"].shape[0]
                                )
                present_per_file.append(present)
        per_file_counts = [
            {n: count for n, count in present.items() if n + 1 in present}
            for present in present_per_file
        ]

        num_segments = []
        n_iter = 1
        while True:
            per_file = [
                (file_idx, counts[n_iter])
                for file_idx, counts in enumerate(per_file_counts)
                if n_iter in counts
            ]
            total = sum(n for _idx, n in per_file)
            if total == 0:
                break
            self._iter_index[n_iter] = per_file
            num_segments.append(total)
            n_iter += 1

        self.numSegments = np.array(num_segments, dtype=float)
        self.maxIter = len(num_segments)
        if self.maxIter == 0:
            log.warning(
                f"No usable iterations found in {self._source_name(0)}"
            )
        self.max_segs = int(self.numSegments.max()) if self.maxIter else 0

    # ------------------------------------------------------- per-iteration IO
    def iter_data(self, n_iter):
        """Index data for one iteration (cached; no coordinates).

        Returns a dict with ``weights``, ``parent_ids``, ``pcoord0``,
        ``pcoord1`` (clipped to pcoord_ndim), ``west_idx``, ``seg_idx``,
        ``n_segs``.
        """
        if n_iter in self._iter_data:
            return self._iter_data[n_iter]
        if n_iter not in self._iter_index:
            raise KeyError(f"Iteration {n_iter} not present/usable")
        with self._io_lock:
            return self._iter_data_uncached(n_iter)

    def _iter_data_uncached(self, n_iter):
        # Re-check under the lock: the prefetch thread may have landed it
        # between the lock-free fast path above and acquisition
        if n_iter in self._iter_data:
            return self._iter_data[n_iter]
        weights, parents, p0, p1, west_idx, seg_idx = [], [], [], [], [], []
        for file_idx, _n in self._iter_index[n_iter]:
            seg_index, pcoord = self._read_index(file_idx, n_iter)
            n = len(seg_index)
            weights.append(seg_index["weight"])
            try:
                parents.append(seg_index["parent_id"])
            except (KeyError, ValueError):
                # Positional field 1, as the reference indexes it
                parents.append(np.array([row[1] for row in seg_index]))
            if pcoord.shape[2] < self.pcoord_ndim:
                raise ValueError(
                    f"pcoord in {self._source_name(file_idx)} has only "
                    f"{pcoord.shape[2]} dims but pcoord_ndim="
                    f"{self.pcoord_ndim} was requested"
                )
            if pcoord.shape[2] > self.pcoord_ndim and not self._pcoord_shape_warned:
                # Expected when pcoords were extended by the optimization
                # flow; warn once (reference ``_data.py:878-889``)
                log.warning(
                    f"pcoord in {self._source_name(file_idx)} has "
                    f"{pcoord.shape[2]} dims; loading only the first "
                    f"{self.pcoord_ndim}. This is expected if you're "
                    "extending your pcoord (e.g. in an optimization flow)."
                )
                self._pcoord_shape_warned = True
            self.pcoord_len = int(pcoord.shape[1])
            p0.append(pcoord[:, 0, : self.pcoord_ndim])
            p1.append(pcoord[:, -1, : self.pcoord_ndim])
            west_idx.append(np.full(n, file_idx, dtype=int))
            seg_idx.append(np.arange(n))

        data = dict(
            weights=np.concatenate(weights),
            parent_ids=np.concatenate(parents),
            pcoord0=np.concatenate(p0),
            pcoord1=np.concatenate(p1),
            west_idx=np.concatenate(west_idx),
            seg_idx=np.concatenate(seg_idx),
        )
        data["n_segs"] = len(data["weights"])

        # Parent ids in seg_index are local to each file's previous
        # iteration; offset them into the *concatenated* previous-iteration
        # ordering so ancestry walks work on multi-file datasets (the
        # reference instead re-matches (segind, westfile) pairs,
        # ``_data.py:785-795``). Negative ids (recycled) stay negative.
        prev = self._iter_index.get(n_iter - 1, [])
        offsets_prev = {}
        running = 0
        for f_idx, n in prev:
            offsets_prev[f_idx] = running
            running += n
        global_parents = data["parent_ids"].copy()
        for f_idx in np.unique(data["west_idx"]):
            rows = data["west_idx"] == f_idx
            pos = rows & (global_parents >= 0)
            if pos.any() and n_iter > 1 and int(f_idx) not in offsets_prev:
                raise ValueError(
                    f"{self._source_name(int(f_idx))} has segments in iteration "
                    f"{n_iter} with parents, but no usable iteration "
                    f"{n_iter - 1} -- cannot globalize its parent ids "
                    "(truncated or mid-run file?)"
                )
            global_parents[pos] += offsets_prev.get(int(f_idx), 0)
        data["parent_ids_global"] = global_parents

        self._iter_data[n_iter] = data
        return data

    def _source_name(self, file_idx):
        if self._groups is not None:
            return "the in-memory iterations"
        return self.file_list[file_idx]

    def _read_index(self, file_idx, n_iter):
        """(seg_index, pcoord) arrays of one iteration in one file."""
        if self._groups is not None:
            group = self._groups[n_iter - 1]
            return group["seg_index"], group["pcoord"]
        from h5py import h5o

        h5 = self._h5(file_idx)
        gid = h5o.open(h5.id, _iter_name(n_iter).encode())
        si_id = h5o.open(gid, b"seg_index")
        pc_id = h5o.open(gid, b"pcoord")
        si_dtype, pc_dtype = self._index_dtypes(file_idx, si_id, pc_id)
        return _ll_read_full(si_id, si_dtype), _ll_read_full(pc_id, pc_dtype)

    def iter_coord_pairs(self, n_iter):
        """(parent_coords, child_coords, weights) for one iteration.

        Coordinates are frames 0 and -1 of ``auxdata/<auxpath>``; segments with
        NaN coordinates keep their (NaN) coords but get weight 0, the
        reference's convention for bad augmentation data
        (``_data.py:303-313``).
        """
        data = self.iter_data(n_iter)
        n = data["n_segs"]
        per_file = self._iter_index[n_iter]
        if len(per_file) == 1:
            # Single-file iteration (the common case): the h5 reads ARE the
            # concatenated blocks -- skip the NaN-filled f64 staging copy,
            # which silently upcast f32 coords to f64 and doubled every
            # downstream featurization pass (same fast path as
            # _iter_frame_block)
            dset = self._aux_dset(per_file[0][0], n_iter)
            if dset.shape[1] <= 4 and dset.nbytes <= 256 << 20:
                # One contiguous read serves both endpoint frames (see
                # _iter_frame_block's fast path for the measurement)
                full = self._aux_full(per_file[0][0], n_iter)
                parent = np.ascontiguousarray(full[:, 0])
                child = np.ascontiguousarray(full[:, -1])
            else:
                parent = dset[:, 0]
                child = dset[:, -1]
            if len(parent) != n:
                raise ValueError(
                    f"iteration {n_iter}: auxdata has {len(parent)} segments "
                    f"but seg_index has {n} (truncated augmentation write?)"
                )
        else:
            # Multi-file: stage into arrays whose dtype promotes over ALL
            # blocks (mixed f32/f64 augmentation versions)
            blocks = [
                (file_idx, self._aux_dset(file_idx, n_iter))
                for file_idx, _n in per_file
            ]
            dtype = np.result_type(np.float32, *(d.dtype for _, d in blocks))
            shape = (n,) + blocks[0][1].shape[2:]
            parent = np.full(shape, np.nan, dtype=dtype)
            child = np.full(shape, np.nan, dtype=dtype)
            for file_idx, dset in blocks:
                mask = data["west_idx"] == file_idx
                parent[mask] = dset[:, 0]
                child[mask] = dset[:, -1]

        weights = data["weights"].copy()
        flat_axes = tuple(range(1, parent.ndim))
        bad = np.isnan(parent).any(axis=flat_axes) | np.isnan(child).any(axis=flat_axes)
        if bad.any():
            log.warning(
                f"Bad coordinates for segments {np.flatnonzero(bad)} in iteration "
                f"{n_iter}, setting weights to 0"
            )
            weights[bad] = 0.0
        return parent, child, weights

    def ancestor_ids(self, n_iter, n_lag):
        """Vectorized ancestry walk: each segment's ancestor ``n_lag``
        iterations back.

        Returns ``(anc, warped)``: ``anc[s]`` is the index (into iteration
        ``n_iter - n_lag``'s concatenated ordering) of segment ``s``'s
        ancestor, and ``warped[s]`` is True when the lineage was recycled
        anywhere inside the window (in which case ``anc[s]`` is -1).

        The reference walks the same chains one Python h5 read per segment
        per step (``get_seg_histories``, ``_data.py:322-421``); here each
        step is one gather on the cached ``parent_ids_global`` arrays.
        """
        if n_lag < 0 or n_iter - n_lag < 1:
            raise ValueError(
                f"Iteration {n_iter} has no ancestry {n_lag} iterations back"
            )
        n = self.iter_data(n_iter)["n_segs"]
        anc = np.arange(n)
        warped = np.zeros(n, dtype=bool)
        for h in range(1, n_lag + 1):
            parents = self.iter_data(n_iter - h + 1)["parent_ids_global"]
            step = np.where(warped, -1, parents[np.where(warped, 0, anc)])
            warped |= step < 0
            anc = np.where(warped, -1, step)
        return anc, warped

    def iter_transition_pairs(self, n_iter, n_lag, basis_coords=None):
        """Transition pairs at lag ``n_lag`` ending in iteration ``n_iter``.

        Semantics (a clean generalization of the lag-0 rule; the reference
        carries an unreachable, self-inconsistent lag>0 path at
        ``_data.py:48-252``, so this *exceeds* it):

        * start = frame 0 of the segment's ancestor ``n_lag`` iterations
          back; end = the segment's final frame. At ``n_lag=0`` this is
          exactly :meth:`iter_coord_pairs`.
        * a lineage recycled inside the window starts from ``basis_coords``
          instead (the post-warp trajectory was born in the basis); target
          absorption needs no special casing because end-in-target segments
          are overridden to the target state downstream, same as lag 0.
        * ``weights`` (transition weights) are the current iteration's;
          ``departure_weights`` are the ancestor's at ``n_iter - n_lag``
          (current weight for warped lineages).

        Returns a dict with ``start``, ``end``, ``weights``,
        ``departure_weights``, ``start_pcoord``, ``warped``, ``anc``.
        """
        if n_lag == 0:
            parent, child, weights = self.iter_coord_pairs(n_iter)
            d = self.iter_data(n_iter)
            return dict(
                start=parent, end=child, weights=weights,
                departure_weights=weights.copy(),
                start_pcoord=d["pcoord0"].copy(),
                warped=np.zeros(d["n_segs"], bool),
                anc=np.arange(d["n_segs"]),
            )

        anc, warped = self.ancestor_ids(n_iter, n_lag)
        if warped.any() and basis_coords is None:
            raise ValueError(
                f"Iteration {n_iter} has lineages recycled within the lag-"
                f"{n_lag} window; basis_coords is required to substitute "
                "their start structures (reference semantics, _data.py:170-182)"
            )

        d_now = self.iter_data(n_iter)
        d_lag = self.iter_data(n_iter - n_lag)
        # Only the two frames the lagged pair actually uses are read (half
        # the aux I/O of iter_coord_pairs), and only THEIR NaNs zero the
        # weight: frame 0 of the current iteration is irrelevant to a
        # lag>0 transition, so its NaNs must not zero a valid pair
        start_all = self._iter_frame_block(n_iter - n_lag, 0)
        end = self._iter_frame_block(n_iter, -1)
        weights = d_now["weights"].copy()
        end_axes = tuple(range(1, end.ndim))
        bad_end = np.isnan(end).any(axis=end_axes)
        if bad_end.any():
            log.warning(
                f"Bad end-frame coordinates for segments "
                f"{np.flatnonzero(bad_end)} in iteration {n_iter}, setting "
                "weights to 0"
            )
            weights[bad_end] = 0.0

        safe = np.where(warped, 0, anc)
        start = start_all[safe].copy()
        start_pcoord = d_lag["pcoord0"][safe].copy()
        departure = d_lag["weights"][safe].copy()
        if warped.any():
            start[warped] = np.asarray(basis_coords, dtype=start.dtype)
            # A recycled lineage has no ancestor pcoord; NaN start pcoords
            # tell the caller to treat these rows as basis departures
            start_pcoord[warped] = np.nan
            departure[warped] = d_now["weights"][warped]

        # NaN start coordinates zero the transition weight, the lag-0
        # convention (``_data.py:303-313``) applied to the lagged frame
        flat_axes = tuple(range(1, start.ndim))
        bad = np.isnan(start).any(axis=flat_axes) & ~warped
        w = weights.copy()
        if bad.any():
            w[bad] = 0.0
        return dict(
            start=start, end=end, weights=w, departure_weights=departure,
            start_pcoord=start_pcoord, warped=warped, anc=anc,
        )

    def _iter_frame_block(self, n_iter, frame, consume=False, transient=False):
        """One frame's coordinates for every segment of an iteration (NaN
        kept), reading only that frame from ``auxdata`` -- half the I/O of
        :meth:`iter_coord_pairs` when only one endpoint is needed.

        With :meth:`enable_block_cache` active, a block read once is kept
        (within budget) for later readers of the same (iteration, frame).
        Cached blocks are shared read-only views of the same array; a caller
        that will mutate the block in place must pass ``consume=True``, which
        takes the entry out of the cache (ownership transfer) -- and never
        stores its own read.

        ``transient=True`` is for callers that only *gather-copy* from the
        block (``iter_frame_subset``, continuity checks): a miss is read
        WITHOUT storing (continuity touches frame 0 of every usable
        iteration; caching those filled the budget with blocks the
        featurizer never consumes, starving phase-2 prefetch), and a hit is
        returned WITHOUT the ``_block_shared`` mark (fancy indexing copies,
        so a later ``consume=True`` owner may still mutate the original).
        """
        key = (n_iter, frame)
        with self._io_lock:
            cache = getattr(self, "_block_cache", None)
            if cache is not None and key in cache:
                if consume:
                    block = cache.pop(key)
                    self._block_used -= block.nbytes
                    self._block_consumed.add(key)
                    if key in self._block_shared:
                        # An earlier plain hit handed out a view of this
                        # array; the consumer is about to mutate it in
                        # place, so it must get its own copy
                        block = block.copy()
                else:
                    block = cache[key]
                    if not transient:
                        self._block_shared.add(key)
                return block
            if consume and cache is not None:
                # Mark before reading: the prefetch thread must not re-read
                # a block the consumer is already fetching for itself
                self._block_consumed.add(key)
        block = self._read_frame_block(n_iter, frame)
        with self._io_lock:
            cache = getattr(self, "_block_cache", None)
            if (
                cache is not None
                and not consume
                and not transient
                and key not in cache
                and self._block_used + block.nbytes <= self._block_budget
            ):
                cache[key] = block
                self._block_used += block.nbytes
        return block

    def _read_frame_block(self, n_iter, frame):
        data = self.iter_data(n_iter)
        per_file = self._iter_index[n_iter]
        n = data["n_segs"]
        if len(per_file) == 1:
            # Single-file iteration (the common case): the h5 read IS the
            # concatenated block -- skip the NaN-filled f64 staging copy
            # (which also silently upcast f32 coords to f64, doubling every
            # downstream featurization pass)
            dset = self._aux_dset(per_file[0][0], n_iter)
            if dset.shape[1] <= 4 and dset.nbytes <= (4 << 20):
                # Few stored frames (the lag-0 WE norm is 2) and a small
                # block: one contiguous full read + numpy slice beats HDF5's
                # strided single-frame hyperslab (measured 0.023 vs 0.027 ms
                # at 192 KB). Above ~4 MB the ratio flips -- at 19.2 MB
                # blocks (100k-segment iterations) the strided read is 2.2x
                # faster (8.0 vs 17.9 ms) AND skips the ascontiguousarray
                # copy of the full-read slice, so large iterations take the
                # strided path.
                block = np.ascontiguousarray(
                    self._aux_full(per_file[0][0], n_iter)[:, frame]
                )
            else:
                block = dset[:, frame]
            if len(block) != n:
                # Keep the loud failure the staging copy used to provide
                # (a broadcast error) for truncated/partial auxdata writes
                raise ValueError(
                    f"iteration {n_iter}: auxdata has {len(block)} segments "
                    f"but seg_index has {n} (truncated augmentation write?)"
                )
            return block
        # Read every file's block first so the output dtype promotes over
        # ALL of them (files written by different augmentation versions may
        # mix f32/f64; fixing the dtype from the first block would silently
        # truncate wider later blocks)
        blocks = [
            (file_idx, self._aux_dset(file_idx, n_iter)[:, frame])
            for file_idx, _n in per_file
        ]
        dtype = np.result_type(np.float32, *(b.dtype for _, b in blocks))
        out = np.full((n,) + blocks[0][1].shape[1:], np.nan, dtype=dtype)
        for file_idx, block in blocks:
            out[data["west_idx"] == file_idx] = block
        return out

    def iter_frame_subset(self, n_iter, rows, frame):
        """One frame's coordinates for a subset of segments (concatenated-
        order ``rows``).

        Small iterations are served by one whole-block read (hitting the
        block cache when present) plus a numpy gather: HDF5's point/fancy
        selection machinery costs ~0.2 ms per call regardless of row count
        (99 recycled-row reads + the dedup verify sample = ~35 ms of a warm
        100k build), while the full contiguous read of a small WE iteration
        is ~0.023 ms. LARGE uncached blocks with SPARSE rows take the
        row-selective read: at 100k-segment iterations (9.6 MB/frame) a
        selective 100-row read is 0.62 ms (~5 us/row) vs 8-18 ms for the
        whole block -- the old 32 MB whole-block cutoff cost ~1.6 s of a
        10M-segment featurize stage (cProfile, 391 subset calls). Dense
        row sets keep the whole-block read: HDF5 fancy selection of ~all
        rows is pathological (~10x the contiguous read of the same
        bytes)."""
        data = self.iter_data(n_iter)
        rows = np.asarray(rows, dtype=np.int64)
        key = (n_iter, frame)
        with self._io_lock:
            cache = getattr(self, "_block_cache", None)
            cached = cache is not None and key in cache
        if (
            cached
            or self._block_nbytes_estimate() <= 2 << 20
            or len(rows) * 16 >= data["n_segs"]
        ):
            # Fancy indexing copies, so mutating the result never reaches
            # the (shared) cached block; transient: don't pollute the block
            # cache with frame-0 blocks the featurizer never consumes
            return self._iter_frame_block(n_iter, frame, transient=True)[rows]
        n_atoms, coord_ndim = self.n_atoms_coord_ndim()
        # Read all per-file pieces first, then allocate at the dtype
        # promoted over them (floored at f32) -- the whole-block path
        # returns native-dtype arrays, and a silent np.full-default f64
        # upcast here would make the SAME call site flip dtype with cache
        # state (breaking e.g. featurize_dedup's bitwise verify sample on
        # f32 datasets) and double the gather memory
        pieces = []
        for file_idx, _n in self._iter_index[n_iter]:
            in_file = np.flatnonzero(data["west_idx"][rows] == file_idx)
            if not len(in_file):
                continue
            local = data["seg_idx"][rows[in_file]]
            # h5py wants strictly increasing unique indices; rows may repeat
            # (split walkers share a parent)
            uniq, inverse = np.unique(local, return_inverse=True)
            dset = self._aux_dset(file_idx, n_iter)
            pieces.append((in_file, dset[uniq, frame], inverse))
        dtype = np.result_type(
            np.float32, *(b.dtype for _if, b, _inv in pieces)
        ) if pieces else np.float32
        out = np.full((len(rows), n_atoms, coord_ndim), np.nan, dtype=dtype)
        for in_file, block, inverse in pieces:
            out[in_file] = block[inverse]
        return out

    def check_continuity(self, sample_per_iter=8, full_iters=2, seed=0,
                         last_iter=None):
        """True iff segments' frame-0 coordinates are bit-identical to their
        parent's final frame (WE trajectory continuity).

        WESTPA propagators start each segment from the parent's final
        structure, so augmented coords normally satisfy this exactly; it can
        fail when the augmentation stores the child's first *saved* MD frame
        instead (one step past the restart point). All rows of the first
        ``full_iters`` usable iterations are checked, plus ``sample_per_iter``
        random rows of every other iteration. NaN patterns must match too.

        The check is *sampled* past the first iterations because an
        exhaustive check would read back exactly the frame-0 data the dedup
        exists to avoid reading. It therefore detects convention-level
        mismatches (a writer that never copies parent frames), not isolated
        row corruption -- callers needing per-row guarantees should disable
        dedup instead.

        The verdict is memoized per (file identity, parameters): repeated
        builds over unchanged files (restart marathons, validation splits)
        skip the re-verification. A rewritten file (new mtime/size) is
        re-checked.
        """
        import os

        try:
            if self._groups is not None:
                raise OSError("in-memory iterations have no file identity")
            # (realpath, inode, mtime_ns, size): an in-place same-size
            # rewrite inside one mtime tick can still alias (filesystem
            # timestamp granularity) -- callers mutating files they just
            # checked should reopen under a new Dataset or touch the file
            ident = tuple(
                (os.path.realpath(p),)
                + (lambda s: (s.st_ino, s.st_mtime_ns, s.st_size))(os.stat(p))
                for p in self.file_list
            )
            memo_key = (
                ident, self.pcoord_ndim, self.auxpath,
                sample_per_iter, full_iters, seed, last_iter,
            )
        except OSError:
            memo_key = None
        if memo_key is not None and memo_key in _continuity_memo:
            return _continuity_memo[memo_key]
        result = self._check_continuity_uncached(
            sample_per_iter, full_iters, seed, last_iter
        )
        if memo_key is not None:
            _continuity_memo[memo_key] = result
        return result

    def _check_continuity_uncached(self, sample_per_iter, full_iters, seed,
                                   last_iter):
        rng = np.random.default_rng(seed)
        # Bound to the range actually consumed (a corrupt tail beyond the
        # featurized iterations should not disable dedup for the clean range)
        usable = sorted(
            i
            for i in self._iter_index
            if i >= 2 and (last_iter is None or i <= last_iter)
        )
        for pos, i in enumerate(usable):
            d = self.iter_data(i)
            rows = np.flatnonzero(d["parent_ids_global"] >= 0)
            if not len(rows):
                continue
            if i - 1 not in self._iter_index:
                return False
            if pos >= full_iters and sample_per_iter < len(rows):
                rows = np.sort(rng.choice(rows, sample_per_iter, replace=False))
            own_start = self.iter_frame_subset(i, rows, 0)
            parent_end = self.iter_frame_subset(
                i - 1, d["parent_ids_global"][rows], -1
            )
            if not np.array_equal(own_start, parent_end, equal_nan=True):
                return False
        return True

    def iter_child_coords(self, n_iter):
        """Final-frame coordinates of each segment (reference
        ``load_iter_coordinates``, ``_data.py:557-618``). NaN rows dropped.
        Reads only the final frame (half the I/O of iter_coord_pairs)."""
        child = self._iter_frame_block(n_iter, -1)
        good = ~np.isnan(child).any(axis=tuple(range(1, child.ndim)))
        return child[np.flatnonzero(good)]

    def n_atoms_coord_ndim(self):
        """(n_atoms, coord_ndim) of the augmented coordinates (memoized:
        this was re-read from the file on every subset read, ~0.2 s of a
        warm 100-iteration clustering stage)."""
        if self._coord_shape is None:
            first = next(iter(self._iter_index))
            file_idx, _ = self._iter_index[first][0]
            shape = self._aux_dset(file_idx, first).shape
            self._coord_shape = (shape[2], shape[3])
        return self._coord_shape
