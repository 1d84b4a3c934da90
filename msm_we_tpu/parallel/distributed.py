"""True multi-process execution: ``jax.distributed`` over per-process shards.

The reference joins multi-node Ray clusters and fans WE iterations out as Ray
tasks (``msm_we.py:639-641,697-711``; ``hamsm_driver.py:78,110-111``). The
JAX equivalent is SPMD: every process calls
:func:`jax.distributed.initialize`, reads ONLY its own shard of the segment
data (one west.h5/feature shard per host), assembles the global arrays with
``jax.make_array_from_process_local_data`` against the global mesh's
``P('data')`` sharding, and runs the same fused discretize+flux step as the
single-process path -- the in-mesh ``psum`` over 'data' rides the
collectives instead of a driver-side gather.

``run_worker`` is the per-process entry point; ``launch_local_dryrun``
spawns ``n_procs`` CPU processes on this machine (Gloo collectives) and
asserts the global flux matrix is bit-identical to the single-process
result. The wrapper is ``__graft_entry__.dryrun_distributed``.

This is a CPU dry run: every worker pins itself to the CPU platform, so it
never opens a GPU (one process per card stays the rule). Multi-process
ingest over NCCL on GPUs is not implemented.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

__all__ = ["run_worker", "launch_local_dryrun"]

_ROW_KEYS = ["fp", "fc", "pbins", "cbins", "basis_p", "basis_c", "target_c", "w"]
_BANK_KEYS = ["centers", "center_bin", "valid"]


def _write_shards(problem, n_procs, workdir):
    """Split the row arrays into contiguous per-process h5 shards.

    The split matches the global ``P('data')`` layout: process ``i`` gets
    rows ``[i*N/n, (i+1)*N/n)``, which is exactly the block its devices own
    in the assembled global array.
    """
    import h5py

    N = len(problem["w"])
    assert N % n_procs == 0
    block = N // n_procs
    paths = []
    for i in range(n_procs):
        path = os.path.join(workdir, f"shard_{i}.h5")
        with h5py.File(path, "w") as h5:
            for key in _ROW_KEYS:
                h5[key] = np.asarray(problem[key])[i * block : (i + 1) * block]
        paths.append(path)
    bank_path = os.path.join(workdir, "bank.h5")
    with h5py.File(bank_path, "w") as h5:
        for key in _BANK_KEYS:
            h5[key] = np.asarray(problem[key])
        h5.attrs["n_states"] = problem["n_states"]
        h5.attrs["n_bins"] = int(np.asarray(problem["center_bin"]).max()) + 1
        h5.attrs["n_rows_global"] = N
    return paths, bank_path


def _model_parallel(local_devices):
    """Model-axis size for a dryrun worker's mesh, from its per-process
    device count. Single source of truth: every job in a comparison
    (multi-process AND the single-process reference) must receive the SAME
    value -- deriving it independently per job diverges for odd
    per-process device counts (2 procs x 3 devices -> (6,1) vs the
    reference's 6 devices -> (3,2)), breaking the bitwise-mesh premise."""
    return 2 if local_devices % 2 == 0 else 1


def run_worker(
    rank,
    n_procs,
    coordinator,
    shard_path,
    bank_path,
    out_path,
    local_devices=2,
    model_parallel=None,
):
    """Per-process worker: init jax.distributed, ingest own shard, run the
    sharded step, write the (replicated) flux matrix from process 0."""
    # Platform setup must precede any jax backend initialization
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={local_devices}"
        ).strip()

    import h5py
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator, num_processes=n_procs, process_id=rank
    )

    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import make_mesh
    from .sharded import build_sharded_step

    # Each process reads ONLY its own shard -- the multi-host ingest contract
    with h5py.File(shard_path, "r") as h5:
        local = {key: h5[key][:] for key in _ROW_KEYS}
    with h5py.File(bank_path, "r") as h5:
        bank = {key: h5[key][:] for key in _BANK_KEYS}
        n_states = int(h5.attrs["n_states"])
        n_bins = int(h5.attrs["n_bins"])
        n_rows_global = int(h5.attrs["n_rows_global"])

    # The model axis must divide the per-process device count: process i's
    # devices then form whole, contiguous data-axis rows, which is exactly
    # the _write_shards contract (process i owns row block i). Letting
    # make_mesh factor globally can put the WHOLE row dimension on one
    # data row (e.g. 2 procs x 1 device -> mesh (1, 2)), where
    # make_array_from_process_local_data requires every process to hold
    # every row -- a contract violation that crashes
    if model_parallel is None:
        model_parallel = _model_parallel(local_devices)
    mesh = make_mesh(jax.devices(), model_parallel=model_parallel)
    data_sharding = NamedSharding(mesh, P("data"))
    model_sharding = NamedSharding(mesh, P("model"))

    rows = {
        key: jax.make_array_from_process_local_data(
            data_sharding,
            local[key],
            (n_rows_global,) + local[key].shape[1:],
        )
        for key in _ROW_KEYS
    }
    # The bank is replicated on disk; each process's devices jointly hold
    # every model shard, so the process-local portion is the full array
    bank_arrays = {
        key: jax.make_array_from_process_local_data(
            model_sharding, bank[key], bank[key].shape
        )
        for key in _BANK_KEYS
    }

    step = build_sharded_step(mesh, n_states, n_bins=n_bins)
    fm = step(*[rows[k] for k in _ROW_KEYS], *[bank_arrays[k] for k in _BANK_KEYS])
    fm.block_until_ready()

    if rank == 0:
        # out_specs=P() -> replicated; any addressable shard is the result
        np.save(out_path, np.asarray(fm.addressable_data(0)))
    # Let every process reach the end before the coordinator tears down
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("dryrun_done")


def _worker_main():
    (
        rank, n_procs, coordinator, shard, bank, out, local_devices,
        model_parallel,
    ) = sys.argv[1:9]
    run_worker(
        int(rank), int(n_procs), coordinator, shard, bank, out,
        local_devices=int(local_devices),
        model_parallel=int(model_parallel),
    )


def _run_job(problem, n_procs, local_devices, port, timeout,
             model_parallel=None):
    """Write shards, spawn ``n_procs`` worker processes, return the flux
    matrix written by rank 0."""
    if model_parallel is None:
        model_parallel = _model_parallel(local_devices)
    with tempfile.TemporaryDirectory(prefix="msm_we_tpu_dist_") as workdir:
        shards, bank_path = _write_shards(problem, n_procs, workdir)
        out_path = os.path.join(workdir, "fm.npy")

        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)  # workers pin cpu themselves
        env.pop("XLA_FLAGS", None)  # workers set their own device count
        procs = []
        for rank in range(n_procs):
            cmd = [
                sys.executable, "-m", "msm_we_tpu.parallel.distributed",
                str(rank), str(n_procs), f"localhost:{port}",
                shards[rank], bank_path, out_path, str(local_devices),
                str(model_parallel),
            ]
            procs.append(
                subprocess.Popen(
                    cmd, env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                )
            )
        outputs = []
        failed = False
        for proc in procs:
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
                failed = True
            outputs.append(out.decode(errors="replace"))
            failed = failed or proc.returncode != 0
        if failed:
            raise RuntimeError(
                "distributed dryrun worker failed:\n"
                + "\n--- worker ---\n".join(outputs)
            )
        return np.load(out_path)


def _free_port():
    """An OS-assigned free TCP port (hard-coded ports collide with
    concurrent CI jobs). There is a small close-to-rebind race window;
    :func:`_run_job_retrying` retries with a fresh port on failure."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_PORT_RACE_MARKERS = (
    "address already in use", "failed to bind", "bind failed",
    "connection refused", "failed to connect",
)


def _run_job_retrying(problem, n_procs, local_devices, port, timeout,
                      attempts=3, model_parallel=None):
    """Run a job, retrying with a fresh ephemeral port ONLY when the
    failure looks like a coordinator bind/connect race (a concurrent
    process stole the picked port between _free_port() and the workers'
    bind). Any other failure propagates immediately -- retrying would mask
    real intermittent multi-process bugs."""
    for attempt in range(attempts):
        use_port = port if (port is not None and attempt == 0) else _free_port()
        try:
            return _run_job(problem, n_procs, local_devices, use_port, timeout,
                            model_parallel=model_parallel)
        except RuntimeError as e:
            text = str(e).lower()
            is_port_race = any(m in text for m in _PORT_RACE_MARKERS)
            if not is_port_race or attempt == attempts - 1:
                raise


def launch_local_dryrun(n_procs=2, local_devices=2, port=None, timeout=300,
                        awkward=False):
    """Spawn ``n_procs`` real OS processes running :func:`run_worker` over a
    shared-nothing shard split, and assert the global flux matrix equals the
    single-process result exactly.

    The single-process reference runs in ONE subprocess holding all
    ``n_procs * local_devices`` devices -- the same backend, mesh shape and
    collectives, so with the dyadic test weights the comparison is bitwise.
    Returns the (n_states, n_states) flux matrix.

    ``awkward=True`` runs the boundary-stress variant instead of the
    divisible shapes: ragged row count padded with inert rows (the facade's
    padding contract), a WE-bin count not divisible by the model axis, and
    a center bank padded across shard boundaries.
    """
    from ..testing import pad_stratified_problem, tiny_stratified_problem

    n_global = n_procs * local_devices
    # One derivation for every job in the comparison: the single-process
    # reference holds n_global devices but must build the SAME (data, model)
    # mesh shape as the multi-process workers (see _model_parallel)
    model_parallel = _model_parallel(local_devices)
    if awkward:
        data_size = n_global // model_parallel
        n_bins = model_parallel + 1  # does not divide the model axis
        raw_rows = 16 * data_size + 7  # ragged final shard before padding
        raw = tiny_stratified_problem(
            n_rows=raw_rows, n_bins=n_bins, k=3, seed=3
        )
        K = n_bins * 3
        K_pad = -(-K // model_parallel) * model_parallel
        # Rows must split evenly over processes AND over the data axis;
        # a multiple of n_global satisfies both
        N_pad = -(-raw_rows // n_global) * n_global
        problem = pad_stratified_problem(raw, N_pad, K_pad)
    else:
        problem = tiny_stratified_problem(n_rows=32 * n_global, seed=3)

    fm_multi = _run_job_retrying(
        problem, n_procs, local_devices, port, timeout,
        model_parallel=model_parallel,
    )
    fm_single = _run_job_retrying(
        problem, 1, n_global, port + 1 if port is not None else None, timeout,
        model_parallel=model_parallel,
    )

    np.testing.assert_array_equal(fm_multi, fm_single)
    return fm_multi


if __name__ == "__main__":
    _worker_main()
