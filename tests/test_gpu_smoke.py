"""GPU smoke tier: run with ``make gpu-tests`` (or ``chip_smoke.py``) after
any change to kernels/, smc.py or parallel/.  One pytest process on the
card — faults that depend on the device's compiler or on large batch sizes
are invisible to the CPU tiers.

Also hosts the reference-scale statistical gate: 1e7 bp at Np=1000 (the
reference CI config, test_const_pop_size.py:17-32), which would take about
an hour in the CPU tier.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _const_demo(ne=10000.0, n=4, L=2e6, E=1):
    from smcsmc_tpu.demography import Demography

    change = (
        np.array([0.0])
        if E == 1
        else np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)])
    )
    return Demography(
        change_times=change,
        pop_sizes=np.full((E, 1), ne),
        mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=L,
    )


def test_device_is_gpu():
    import jax

    dev = jax.devices()[0]
    assert dev.platform == "gpu", dev


def test_p1000_sweep_smoke():
    """One P=1000 sweep on the device: finite LogL, resamples happened,
    E-step Ne within 2x.  Exercises the population-batched while loops at a
    batch size where vmapped-while lane masking used to miscompile."""
    from smcsmc_tpu.em import EMConfig, run_chunk
    from smcsmc_tpu.simulate import simulate_seg

    ne = 10000.0
    demo = _const_demo(ne=ne, L=2e6, E=8)
    seg = simulate_seg(demo, seed=11)
    cfg = EMConfig(num_particles=1000, block_size=256)
    stats, _, logl, diag = run_chunk(demo, seg, cfg, seed=2)
    assert np.isfinite(logl) and logl < 0
    assert diag["num_resamples"] > 0
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert 0.5 * ne < ne_hat < 2.0 * ne, ne_hat


def test_reference_scale_recovery():
    """Reference-scale gate: 1e7 bp, Np=1000, constant Ne — pooled estimate
    within ±5% of truth (cf. the reference's ±1% at test_const_pop_size.py:
    42-49; that precision uses lag calibration + 1000 particles + repeated
    EM, so ±5% for one E-step is the appropriate pre-registered bound)."""
    from smcsmc_tpu.em import EMConfig, run_chunk
    from smcsmc_tpu.simulate import simulate_seg

    ne = 10000.0
    demo = _const_demo(ne=ne, n=4, L=1e7, E=1)
    seg = simulate_seg(demo, seed=31)
    cfg = EMConfig(num_particles=1000, block_size=512)
    stats, _, logl, diag = run_chunk(demo, seg, cfg, seed=3)
    assert np.isfinite(logl) and logl < 0
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert ne_hat == pytest.approx(ne, rel=0.05), ne_hat
    r_hat = float(stats.recomb_cnt.sum() / stats.recomb_opp.sum())
    assert r_hat == pytest.approx(1e-9, rel=0.25), r_hat


def test_apf_sweep_on_device():
    """APF (-apf 2) exercised on the device — the CPU tier's invariance
    tests are slow-marked.  One P=1000 lookahead-weighted sweep: finite
    LogL, resamples, E-step Ne within 2x, and the pilot-weight machinery actually engaged
    (APF changes the resampling distribution, so ln_norm must differ from
    the plain run on the same data/seed)."""
    from smcsmc_tpu.em import EMConfig, run_chunk
    from smcsmc_tpu.simulate import simulate_seg

    ne = 10000.0
    demo = _const_demo(ne=ne, L=2e6, E=8)
    seg = simulate_seg(demo, seed=11)
    cfg = EMConfig(num_particles=1000, block_size=256, apf=2)
    stats, _, logl, diag = run_chunk(demo, seg, cfg, seed=2)
    assert np.isfinite(logl) and logl < 0
    assert diag["num_resamples"] > 0
    ne_hat = float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))
    assert 0.5 * ne < ne_hat < 2.0 * ne, ne_hat
    cfg0 = EMConfig(num_particles=1000, block_size=256)
    _, _, logl0, _ = run_chunk(demo, seg, cfg0, seed=2)
    assert logl != logl0
