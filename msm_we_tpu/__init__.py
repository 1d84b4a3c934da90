"""msm_we_tpu: haMSM estimation from weighted-ensemble data on JAX.

A ground-up JAX/XLA re-design with the capability surface of the
reference ``msm_we`` package (see SURVEY.md): WESTPA ``west.h5`` ingest,
featurization and dimensionality reduction, (stratified per-WE-bin) k-means
clustering, weighted flux-matrix estimation, steady-state/committor/flux
analysis, first-passage-time engines, WE bin/allocation optimization, and
WESTPA plugin drivers.
"""

__version__ = "0.5.0"

from . import utils  # noqa: F401
from ._logging import log  # noqa: F401
from .msm import (  # noqa: F401
    DirectFPT,
    DiscreteEnsemble,
    DiscretePathEnsemble,
    Ensemble,
    MarkovFPT,
    MarkovPlusColorModel,
    MatrixFPT,
    NonMarkovFPT,
    NonMarkovModel,
    PathEnsemble,
)

# Heavier, JAX-dependent pieces load lazily so that
# `from msm_we_tpu import modelWE` works like the reference's
# `from msm_we import modelWE` without paying the JAX import cost for
# kinetics-only use.


def __getattr__(name):
    if name == "modelWE":
        from .model import modelWE

        return modelWE
    if name == "ExtendedModelWE":
        from .extended import ExtendedModelWE

        return ExtendedModelWE
    if name == "optimization":
        # importlib (not `from . import`) -- the latter re-enters this
        # __getattr__ while the submodule attribute isn't set yet
        import importlib

        return importlib.import_module(".optimization", __name__)
    raise AttributeError(f"module 'msm_we_tpu' has no attribute {name!r}")
