"""Jump-to-event migration walk: A/B agreement with the lock-step loop walk.

The two implementations sample the same process (the structured-coalescent
re-coalescence proposal, reference particle.cpp:1266-1488) by different
factorizations; on matched configs their summary statistics must agree to
Monte-Carlo tolerance.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.kernels import transition as T
from smcsmc_tpu.kernels.tree import epochs_from_demography, make_initial_trees


def island_demo(ne=10000.0, m=1e-4, sample_pops=(0, 1)):
    return Demography(
        change_times=np.array([0.0]),
        pop_sizes=np.array([[ne, ne]]),
        mig_rates=np.array([[[0.0, m], [m, 0.0]]]),
        sample_pops=np.array(sample_pops, dtype=np.int32),
    )


def _walk_stats(impl, demo, P=3000, seed=6, max_mig=56):
    os.environ["SMCSMC_MIG_WALK"] = impl
    epochs = epochs_from_demography(demo)
    trees = make_initial_trees(
        jax.random.PRNGKey(seed), epochs, P,
        jnp.asarray(demo.sample_pops), max_mig=max_mig,
    )
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), P)
    trees2, rec = T.recombination_transition(
        keys, trees, epochs, jnp.ones(P, bool), has_migration=True
    )
    return trees2, rec


class TestJumpLoopAgreement:
    """Moment-level agreement between the two walk factorizations."""

    @pytest.mark.parametrize("m", [2.5e-5, 2e-4])
    def test_record_moments_match(self, m):
        demo = island_demo(ne=10000.0, m=m, sample_pops=(0, 0, 1, 1))
        out = {}
        for impl in ("jump", "loop"):
            _, rec = _walk_stats(impl, demo)
            out[impl] = dict(
                mig_ratio=float(np.sum(rec.mig_cnt) / np.sum(rec.mig_opp)),
                coal_opp=float(np.mean(np.sum(rec.coal_opp, axis=(1, 2)))),
                t_c=float(np.mean(rec.coal_height)),
                self_coal=float(
                    np.mean(np.asarray(rec.d_node) == np.asarray(rec.c_node))
                ),
            )
        j, l = out["jump"], out["loop"]
        assert j["mig_ratio"] == pytest.approx(l["mig_ratio"], rel=0.15)
        assert j["coal_opp"] == pytest.approx(l["coal_opp"], rel=0.05)
        assert j["t_c"] == pytest.approx(l["t_c"], rel=0.05)
        assert j["self_coal"] == pytest.approx(l["self_coal"], abs=0.03)

    def test_jump_walk_exact_expectations(self):
        """The jump walk alone against closed-form island expectations:
        E[mig count]/E[mig opportunity] = m, E[coal opp] per lineage pair
        integrates to 2*Ne on average at stationarity."""
        ne, m = 10000.0, 2e-4
        demo = island_demo(ne=ne, m=m, sample_pops=(0, 1))
        _, rec = _walk_stats("jump", demo, P=4000)
        assert float(np.sum(rec.mig_cnt) / np.sum(rec.mig_opp)) == (
            pytest.approx(m, rel=0.08)
        )
        coal_opp = np.sum(np.asarray(rec.coal_opp), axis=(1, 2))
        assert coal_opp.mean() / (2 * ne) == pytest.approx(1.0, rel=0.08)
        # truncation diagnostics stay rare at tail-sized buffers
        assert float(np.mean(rec.walk_capped)) < 0.02

    def test_new_branch_events_sorted_and_below_tc(self):
        """Realized migration events handed to the SPR are ascending and
        lie strictly below the coalescence time."""
        demo = island_demo(ne=10000.0, m=2e-4, sample_pops=(0, 1))
        _, rec = _walk_stats("jump", demo, P=1000)
        ev_t = np.asarray(rec.mig_ev_t)
        t_c = np.asarray(rec.coal_height)
        fin = ev_t < 1e30
        # ascending among finite entries (INF-padded on the right)
        d = np.diff(ev_t, axis=1)
        assert np.all(d[fin[:, 1:] & fin[:, :-1]] > 0)
        active = t_c > 0
        assert np.all(ev_t[fin & active[:, None]] < t_c[active].max() + 1)
        for p in np.nonzero(fin.any(axis=1) & active)[0][:50]:
            assert ev_t[p, fin[p]].max() < t_c[p]
