"""End-to-end haMSM construction example.

Mirrors the reference's ``examples/hamsm_construction.ipynb`` flow on a
synthetic double-well WE dataset: generate data, build the model, estimate
the steady state and target flux, compute committors and flux profiles, run
block validation, make plots, and checkpoint the model.

Run:  python examples/hamsm_construction.py [output_dir]
"""
import os
import sys

import numpy as np

from msm_we_tpu.binning import RectilinearBinMapper
from msm_we_tpu.data import generate_west_h5
from msm_we_tpu.model import modelWE


def featurize(coords):
    """Example featurization: pairwise-style flattened coordinates.

    For MD data this is where you'd compute e.g. backbone distances with
    mdtraj/MDAnalysis. It must map (n, n_atoms, 3) -> (n, n_features).
    """
    return np.asarray(coords).reshape(len(coords), -1)


def main(outdir="/tmp/msm_we_tpu_example"):
    os.makedirs(outdir, exist_ok=True)
    h5_path = os.path.join(outdir, "west.h5")

    print("Generating synthetic WE data (double-well, recycling)...")
    generate_west_h5(h5_path, n_iterations=80, n_segments=32, seed=42)

    model = modelWE()
    model.build_analyze_model(
        file_paths=[h5_path],
        ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
        modelName="example",
        basis_pcoord_bounds=[[9.0, 10.0]],   # unfolded / source
        target_pcoord_bounds=[[0.0, 1.0]],   # folded / sink
        dimreduce_method="pca",
        tau=1.0,
        n_clusters=3,                        # per WE bin (stratified)
        cross_validation_groups=2,
        allow_validation_failure=True,
        step_kwargs={
            "initialize": {"processCoordinates": featurize},
            "clustering": {
                "user_bin_mapper": RectilinearBinMapper([np.linspace(0, 10, 11)])
            },
        },
    )

    print(f"\nSteady-state target flux: {model.JtargetSS:.4e}")
    print(f"States: {model.nBins} (basis={model.indBasis}, target={model.indTargets})")
    print(model.stage_timings.report())

    model.get_committor()
    model.get_flux()
    model.get_flux_committor()

    try:
        import matplotlib

        matplotlib.use("Agg")
        ax = model.plot_flux(suppress_validation=True)
        ax.figure.savefig(os.path.join(outdir, "flux_profile.png"), bbox_inches="tight")
        fig, _ = model.plot_coarse_flux_profile()
        fig.savefig(os.path.join(outdir, "coarse_flux.png"), bbox_inches="tight")
        print(f"Plots written to {outdir}")
    except ImportError:
        print("matplotlib not available; skipping plots")

    model.save(os.path.join(outdir, "hamsm.obj"))
    print(f"Model checkpointed to {outdir}/hamsm.obj")

    # WE bin optimization from the built model
    from msm_we_tpu import optimization

    disc, var = optimization.solve_discrepancy(
        model.Tmatrix, model.pSS, model.indTargets
    )
    new_bins = optimization.get_clustered_mfpt_bins(
        var[:-2], disc[:-2], model.pSS[:-2], n_desired_we_bins=8, seed=42
    )
    print(f"Optimized WE bin assignment for {len(new_bins)} microstates computed.")


if __name__ == "__main__":
    main(*sys.argv[1:])
