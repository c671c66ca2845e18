"""Pilot for the reference-exact const-Ne gate.

Runs the reference's own configuration
(/root/reference/test/old/newtests/test_const_pop_size.py:17-48):
n=2, 1e7 bp, mu=2.5e-8, rho=1e-8, change points [0,.01,.25,.5,1,1.5]x4N0,
Np=1000, em=0, lag=2x survival (calibrate), bias_heights [400],
bias_strengths [3,1] — and prints per-epoch Ne and the recombination-rate
ratio for several (data seed, filter seed) pairs, to pre-register the
intervals of tests/test_gpu_stat_gates.py::test_reference_config_estep.

Reference targets for calibration: epoch 1 [10202,10471] (their estimator
runs ~+3% there), epochs 2-5 within +-1.4%, recomb [9.77e-9, 9.89e-9]
(~-1.5..-2.3% of truth 1e-8).

Usage: python tools/pilot_refgate.py [seed ...]
"""

import sys

sys.path.insert(0, ".")

from smcsmc_tpu._cache import enable_compilation_cache

enable_compilation_cache()

import numpy as np

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.em import EMConfig, run_chunk
from smcsmc_tpu.simulate import simulate_seg


def ref_demo(L=1e7, n=2, ne=10000.0):
    change = np.array([0.0, 400.0, 10000.0, 20000.0, 40000.0, 60000.0])
    E = len(change)
    return Demography(
        change_times=change,
        pop_sizes=np.full((E, 1), ne),
        mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
        mutation_rate=2.5e-8,
        recombination_rate=1e-8,
        sequence_length=L,
    )


def main():
    seeds = [int(s) for s in sys.argv[1:]] or [101, 202]
    ne = 10000.0
    for seed in seeds:
        demo = ref_demo()
        seg = simulate_seg(demo, seed=seed)
        cfg = EMConfig(
            num_particles=1000, block_size=1024, calibrate_lag=True,
            bias_heights=(400.0,), bias_strengths=(3.0, 1.0),
        )
        stats, _, logl, diag = run_chunk(demo, seg, cfg, seed=seed + 7)
        ne_e = stats.coal_opp[:, 0] / (2.0 * stats.coal_cnt[:, 0])
        r = float(stats.recomb_cnt.sum() / stats.recomb_opp.sum())
        print(f"seed {seed}: logl {logl:.1f}")
        for e, v in enumerate(ne_e):
            print(f"  epoch {e}: Ne {v:9.1f}  dev {100 * (v / ne - 1):+6.2f}%")
        print(f"  recomb {r:.4e}  dev {100 * (r / 1e-8 - 1):+6.2f}%")


if __name__ == "__main__":
    main()
