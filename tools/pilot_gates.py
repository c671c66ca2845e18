"""Pilot runs for the round-4 reference-precision statistical gates.

Runs the three scenarios on the device and prints the estimates so the
gate intervals can be pre-registered from evidence:
  (a) const-Ne full EM (3 iters, -calibrate_lag) at 1e7 bp / Np=1000
  (b) two-population split (-ej) recovery
  (c) per-epoch directional migration intervals at 1e7 bp

Usage: python tools/pilot_gates.py [a|b|c] [seed...]
"""

import sys
import time

sys.path.insert(0, ".")
import numpy as np

from smcsmc_tpu._cache import enable_compilation_cache

enable_compilation_cache()

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.em import EMConfig, run_em
from smcsmc_tpu.simulate import simulate_seg


def const_demo(L=1e7, n=4, ne=10000.0):
    # reference change_points [0, .01, .25, .5, 1, 1.5] x 4N0
    change = np.array([0.0, 400.0, 10000.0, 20000.0, 40000.0, 60000.0])
    E = len(change)
    return Demography(
        change_times=change,
        pop_sizes=np.full((E, 1), ne),
        mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=L,
    )


def split_demo(L=1e7, migr=True):
    # reference TwoPopsSplitUniDirMigr: change [0,0.1,0.5]x4N0, backward
    # migration 0->1 at 0.2/4N0 = 5e-6 below the split, -ej 0.5 2 1
    change = np.array([0.0, 4000.0, 20000.0])
    E = len(change)
    mig = np.zeros((E, 2, 2))
    if migr:
        mig[0:2, 0, 1] = 5e-6
    return Demography(
        change_times=change,
        pop_sizes=np.full((E, 2), 10000.0),
        mig_rates=mig,
        sample_pops=np.array([0] * 4 + [1] * 4, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=L,
        splits=[(20000.0, 1, 0)],
    )


def unidir_demo(L=1e7):
    # reference TwoPopUniDirMigr: backward migration 1->0 at 1/4N0 = 2.5e-5,
    # constant over epochs [0, 0.1, 0.5] x 4N0
    change = np.array([0.0, 4000.0, 20000.0])
    E = len(change)
    mig = np.zeros((E, 2, 2))
    mig[:, 1, 0] = 2.5e-5
    return Demography(
        change_times=change,
        pop_sizes=np.full((E, 2), 10000.0),
        mig_rates=mig,
        sample_pops=np.array([0] * 4 + [1] * 4, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=L,
    )


def show_em(res, demo_true):
    for it, (st, d) in enumerate(zip(res.stats, res.demos)):
        ne = st.coal_opp / (2.0 * st.coal_cnt)
        r = st.recomb_cnt.sum() / st.recomb_opp.sum()
        line = f"  it{it}: logl={res.log_likelihoods[it]:.0f} r={r:.3e}"
        for p in range(ne.shape[1]):
            line += " | ne[%d]: " % p + " ".join(
                f"{x:.0f}" for x in ne[:, p]
            )
        if demo_true.num_populations > 1:
            m = st.mig_cnt / np.maximum(st.mig_opp[:, :, None], 1e-300)
            line += " | m01: " + " ".join(f"{x:.2e}" for x in m[:, 0, 1])
            line += " | m10: " + " ".join(f"{x:.2e}" for x in m[:, 1, 0])
        print(line)


def run_a(seed):
    demo = const_demo()
    seg = simulate_seg(demo, seed=seed)
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=3,
                   calibrate_lag=True)
    t0 = time.time()
    res = run_em(demo, seg, cfg)
    print(f"(a) seed={seed} wall={time.time()-t0:.0f}s")
    show_em(res, demo)
    st = res.stats[-1]
    ne_pooled = float(st.coal_opp[1:].sum() / (2 * st.coal_cnt[1:].sum()))
    print(f"  pooled Ne (epochs 1+): {ne_pooled:.0f}")


def run_b(seed):
    truth = split_demo()
    seg = simulate_seg(truth, seed=seed)
    # infer from symmetric starting migration (the reference starts from
    # its initial_migr_rates with both directions at 0.2)
    start = split_demo(migr=False)
    start.mig_rates = np.zeros((3, 2, 2))
    start.mig_rates[0:2, 0, 1] = 5e-6
    start.mig_rates[0:2, 1, 0] = 5e-6
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=2)
    t0 = time.time()
    res = run_em(start, seg, cfg)
    print(f"(b) seed={seed} wall={time.time()-t0:.0f}s")
    show_em(res, truth)


def run_c(seed):
    truth = unidir_demo()
    seg = simulate_seg(truth, seed=seed)
    start = unidir_demo()
    start.mig_rates = np.zeros((3, 2, 2))
    start.mig_rates[:, 1, 0] = 1.25e-5
    start.mig_rates[:, 0, 1] = 1.25e-5
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=2)
    t0 = time.time()
    res = run_em(start, seg, cfg)
    print(f"(c) seed={seed} wall={time.time()-t0:.0f}s")
    show_em(res, truth)


def run_d(seed):
    """Recomb recovery after full EM with the guide loop on (-alpha 0.5) —
    VERDICT r3 weak #5: nothing pins recomb after guide smoothing."""
    import tempfile

    demo = const_demo()
    seg = simulate_seg(demo, seed=seed)
    outdir = tempfile.mkdtemp(prefix="pilot_d_")
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=2,
                   alpha=0.5, outdir=outdir)
    t0 = time.time()
    res = run_em(demo, seg, cfg)
    print(f"(d) seed={seed} wall={time.time()-t0:.0f}s outdir={outdir}")
    show_em(res, demo)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "abc"
    seeds = [int(s) for s in sys.argv[2:]] or [101]
    for s in seeds:
        if "a" in which:
            run_a(s)
        if "b" in which:
            run_b(s)
        if "c" in which:
            run_c(s)
        if "d" in which:
            run_d(s)
