"""Device-mesh construction helpers.

The reference's only distributed substrate is Ray task fan-out over WE
iterations with a driver-side reduction (SURVEY.md P1). The JAX
equivalent is a 2-D ``jax.sharding.Mesh``:

* ``data`` axis: segments (transitions) are sharded -- the analogue of the
  reference's per-iteration Ray tasks;
* ``model`` axis: the stratified cluster-center bank is sharded -- distances
  to each center shard are computed locally and the global argmin is combined
  across the axis (tensor parallelism over the center dimension).

Flux matrices are summed in-mesh with ``psum`` over ``data`` (replacing the
reference's ``ray.wait`` + host summation at ``_fluxmatrix.py:311-342``).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "best_mesh_shape"]


def best_mesh_shape(n_devices, model_parallel=None):
    """(data, model) factorization of ``n_devices``.

    Center banks are small, so the model axis is kept modest (<= 2 by
    default); the data (segment) axis absorbs the rest.
    """
    if model_parallel is None:
        model_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    assert n_devices % model_parallel == 0
    return n_devices // model_parallel, model_parallel


def make_mesh(devices=None, model_parallel=None):
    """Build a ('data', 'model') mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    data, model = best_mesh_shape(n, model_parallel)
    dev_array = np.asarray(devices).reshape(data, model)
    return Mesh(dev_array, axis_names=("data", "model"))
