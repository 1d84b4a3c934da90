#!/usr/bin/env python
"""FPT-engine perf probe: fpt_distribution on a ~1k-state transition
matrix, host f64 loop vs the jitted device engine.

Prints ONE JSON line with host/device wall-clock (best of --repeats warm
runs after one compile run), the parity between the two engines, and an
adaptive_fpt_distribution host timing for the same matrix. Times mean
something only on the accelerator; on CPU it still validates the machinery.

Usage::

    python scripts/fpt_perf.py --n-states 1000 --max-n-lags 100
"""
import argparse
import json
import time

import numpy as np


def random_metastable(n, seed=0):
    rng = np.random.default_rng(seed)
    T = rng.random((n, n)) * 0.02 + np.diag(rng.random(n) * 20 + 1)
    return T / T.sum(axis=1, keepdims=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-states", type=int, default=1000)
    ap.add_argument("--max-n-lags", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--logscale", action="store_true")
    args = ap.parse_args(argv)

    from msm_we_tpu.msm.fpt import MatrixFPT
    from msm_we_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    n = args.n_states
    T = random_metastable(n, seed=1)
    ini = [0, 1, 2]
    fin = [n - 2, n - 1]
    w = [0.5, 0.3, 0.2]
    kwargs = dict(max_n_lags=args.max_n_lags)
    if args.logscale:
        kwargs.update(min_power=1, max_power=4, logscale=True)

    def run(engine):
        t0 = time.perf_counter()
        out = MatrixFPT.fpt_distribution(T, ini, fin, w, engine=engine, **kwargs)
        return time.perf_counter() - t0, out

    host_t, host_out = run("host")
    _compile_t, _ = run("device")  # compile
    dev_times = []
    dev_out = None
    for _ in range(args.repeats):
        t, dev_out = run("device")
        dev_times.append(t)
    host_times = [host_t]
    for _ in range(args.repeats - 1):
        t, _ = run("host")
        host_times.append(t)

    err = float(
        np.max(np.abs(dev_out[:, 1] - host_out[:, 1]))
        / max(float(np.max(np.abs(host_out[:, 1]))), 1e-300)
    )

    t0 = time.perf_counter()
    probs, _all, _i, times_h = MatrixFPT.adaptive_fpt_distribution(
        T, ini, w, fin, max_steps=400, max_time=1e7
    )
    adaptive_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    probs_d, _alld, _id, times_d = MatrixFPT.adaptive_fpt_distribution(
        T, ini, w, fin, max_steps=400, max_time=1e7, engine="device"
    )
    adaptive_dev_s = time.perf_counter() - t0

    import jax

    out = {
        "metric": "fpt_distribution_1k",
        "n_states": n,
        "max_n_lags": args.max_n_lags,
        "logscale": bool(args.logscale),
        "host_s": round(min(host_times), 3),
        "device_s": round(min(dev_times), 4),
        "device_compile_s": round(_compile_t, 2),
        "speedup": round(min(host_times) / min(dev_times), 1),
        "max_rel_diff": err,
        "adaptive_host_s": round(adaptive_s, 3),
        "adaptive_device_s": round(adaptive_dev_s, 3),
        "adaptive_speedup": round(adaptive_s / max(adaptive_dev_s, 1e-9), 1),
        "adaptive_schedule_equal": bool(
            len(times_h) == len(times_d) and np.array_equal(times_h, times_d)
        ),
        "adaptive_mass_captured": float(np.nansum(probs)),
        "adaptive_mass_captured_device": float(np.nansum(probs_d)),
        "backend": jax.default_backend(),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
