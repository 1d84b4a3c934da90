#!/usr/bin/env python
"""Large-scale end-to-end stress harness (VERDICT round-3 item 6).

Generates (and caches) a synthetic west.h5 of the requested size, runs the
full ``build_analyze_model(device_pipeline=True)`` pipeline, and prints ONE
JSON line with wall-clock, per-stage split, peak host RSS, device HBM stats,
and the block-cache/chunking behavior.

Usage::

    python scripts/stress_scale.py --segments-per-iter 100000 --iterations 101
    # ~10.1M segments; the west.h5 is cached in the temporary directory,
    # keyed by the shape

The reference cannot run this shape at all: its per-iteration Ray fan-out
materializes every iteration's coordinates on the driver
(``_hamsm/_clustering.py:1144-1242``) and builds ``pair_dtrajs`` as Python
tuples, which at 10M segments is tens of GB of pointers.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import tempfile
import time


def peak_rss_gb():
    # ru_maxrss is KB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def hbm_stats():
    import jax

    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        return {
            "hbm_peak_gb": round(stats.get("peak_bytes_in_use", 0) / 1e9, 3),
            "hbm_limit_gb": round(stats.get("bytes_limit", 0) / 1e9, 3),
        }
    except Exception:
        return {"hbm_peak_gb": None, "hbm_limit_gb": None}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--segments-per-iter", type=int, default=100_000)
    ap.add_argument("--iterations", type=int, default=101)
    ap.add_argument("--n-clusters", type=int, default=25)
    ap.add_argument("--repeats", type=int, default=2,
                    help="warm builds after the compile build")
    ap.add_argument("--block-cache-mb", type=int, default=None,
                    help="override MSM_WE_TPU_BLOCK_CACHE_MB")
    ap.add_argument("--profile-clustering", action="store_true",
                    help="blocking per-region clustering breakdown "
                         "(observer effect: serializes dispatch overlap)")
    ap.add_argument("--n-bins", type=int, default=12,
                    help="WE bins for the rectilinear mapper (wide-binning "
                         "configs: 128+)")
    args = ap.parse_args(argv)

    if args.profile_clustering:
        os.environ["MSM_WE_TPU_PROFILE_CLUSTERING"] = "1"
    if args.block_cache_mb is not None:
        os.environ["MSM_WE_TPU_BLOCK_CACHE_MB"] = str(args.block_cache_mb)
    import numpy as np

    from msm_we_tpu.binning import RectilinearBinMapper
    from msm_we_tpu.data import generate_west_h5
    from msm_we_tpu.model import modelWE
    from msm_we_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    n_total = args.segments_per_iter * args.iterations
    path = os.path.join(
        tempfile.gettempdir(),
        f"msm_we_tpu_stress_{args.iterations}x{args.segments_per_iter}.h5",
    )
    gen_s = None
    if not os.path.exists(path):
        t0 = time.perf_counter()
        generate_west_h5(
            path + ".tmp",
            n_iterations=args.iterations,
            n_segments=args.segments_per_iter,
            seed=17,
        )
        os.replace(path + ".tmp", path)
        gen_s = round(time.perf_counter() - t0, 1)

    def build():
        mapper = RectilinearBinMapper([np.linspace(0, 10, args.n_bins + 1)])
        model = modelWE()
        t0 = time.perf_counter()
        model.build_analyze_model(
            file_paths=[path],
            ref_struct={"coords": None, "nAtoms": 4, "coord_ndim": 3},
            modelName="stress",
            basis_pcoord_bounds=[[9.0, 10.0]],
            target_pcoord_bounds=[[0.0, 1.0]],
            dimreduce_method="pca",
            tau=1.0,
            n_clusters=args.n_clusters,
            cross_validation_groups=0,
            show_live_display=False,
            device_pipeline=True,
            step_kwargs={
                "clustering": {
                    "user_bin_mapper": mapper,
                    "scan_small_batches": True,
                }
            },
        )
        return time.perf_counter() - t0, model

    cold_s, model = build()
    warms = []
    stages = {}
    for _ in range(args.repeats):
        w, model = build()
        warms.append(round(w, 2))
        stages = {
            name: round(secs, 2) for name, secs, _ in model.stage_timings.stages
        }

    out = {
        "metric": "end_to_end_stress",
        "n_segments_total": n_total,
        "segments_per_iter": args.segments_per_iter,
        "iterations": args.iterations,
        "dataset_gb": round(os.path.getsize(path) / 1e9, 2),
        "generate_s": gen_s,
        "cold_s": round(cold_s, 2),
        "warm_s": warms,
        "warm_best_s": min(warms) if warms else None,
        "stages_last": stages,
        "n_we_bins": args.n_bins,
        "n_centers_nominal": args.n_bins * args.n_clusters,
        "cluster_profile": {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in getattr(model, "_cluster_profile", {}).items()
        },
        "peak_host_rss_gb": round(peak_rss_gb(), 2),
        "block_cache_mb": int(
            os.environ.get("MSM_WE_TPU_BLOCK_CACHE_MB", 512)
        ),
        "JtargetSS": float(model.JtargetSS),
        "n_states_cleaned": int(model.fluxMatrix.shape[0]),
        **hbm_stats(),
    }
    import jax

    out["backend"] = jax.default_backend()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
