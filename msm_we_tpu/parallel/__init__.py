"""Mesh parallelism: sharded discretize+flux pipeline over accelerator devices."""
from .mesh import best_mesh_shape, make_mesh
from .sharded import build_sharded_step, fused_step_single, steady_state_from_flux

__all__ = [
    "make_mesh",
    "best_mesh_shape",
    "build_sharded_step",
    "fused_step_single",
    "steady_state_from_flux",
]
