"""Unit tests for the array-tree kernels, mirroring the reference's
deterministic-fixture strategy (test/old/unittest/test_FroestState.cpp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.kernels.likelihood import _site_likelihood_one, site_likelihood
from smcsmc_tpu.kernels.transition import recombination_transition
from smcsmc_tpu.kernels.tree import (
    Trees,
    branch_length_per_epoch,
    data_branch_length,
    epochs_from_demography,
    lineage_count_at,
    make_initial_trees,
    sample_piecewise_exponential,
    total_branch_length,
)


def hand_tree():
    """n=3: ((0,1):t=1, 2):t=3 — leaves 0,1,2; node 3 at t=1; root 4 at t=3."""
    parent = jnp.array([3, 3, 4, 4, -1], dtype=jnp.int32)
    time = jnp.array([0.0, 0.0, 0.0, 1.0, 3.0], dtype=jnp.float32)
    pop = jnp.zeros(5, dtype=jnp.int32)
    children = jnp.array(
        [[-1, -1], [-1, -1], [-1, -1], [0, 1], [3, 2]], dtype=jnp.int32
    )
    return parent, time, pop, children


def const_demo(ne=10000.0, n=2):
    return Demography(
        change_times=np.array([0.0]),
        pop_sizes=np.array([[ne]]),
        mig_rates=np.zeros((1, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
    )


class TestTreeBasics:
    def test_total_branch_length(self):
        parent, time, pop, children = hand_tree()
        # branches: 0->3 (1), 1->3 (1), 2->4 (3), 3->4 (2); root excluded
        assert total_branch_length(time, parent) == pytest.approx(7.0)

    def test_lineage_count(self):
        parent, time, pop, children = hand_tree()
        t = jnp.array([0.0, 0.5, 1.0, 2.0, 3.0, 10.0])
        k = lineage_count_at(time, parent, t)
        # t=0: 3 leaves; t in (1,3): branches 2->4 and 3->4; t>=3: root lineage
        np.testing.assert_array_equal(np.asarray(k), [3, 3, 2, 2, 1, 1])

    def test_branch_length_per_epoch(self):
        parent, time, pop, children = hand_tree()
        starts = jnp.array([0.0, 1.0, 2.5])
        ends = jnp.array([1.0, 2.5, 3e38])
        ble = branch_length_per_epoch(time, parent, starts, ends)
        # epoch [0,1): 3 branches -> 3; [1,2.5): 2 branches -> 3; [2.5,3): 2->1
        np.testing.assert_allclose(np.asarray(ble), [3.0, 3.0, 1.0], rtol=1e-6)

    def test_data_branch_length(self):
        parent, time, pop, children = hand_tree()
        # all leaves have data: full tree length
        b = data_branch_length(time, parent, children, jnp.array([1, 1, 1], bool))
        assert b == pytest.approx(7.0)
        # only leaves 0,1: paths up to their MRCA (node 3) = 1+1
        b = data_branch_length(time, parent, children, jnp.array([1, 1, 0], bool))
        assert b == pytest.approx(2.0)
        # only leaves 0,2: MRCA is root: 0->3->4 (3) + 2->4 (3) = 6
        b = data_branch_length(time, parent, children, jnp.array([1, 0, 1], bool))
        assert b == pytest.approx(6.0)
        # no data
        b = data_branch_length(time, parent, children, jnp.array([0, 0, 0], bool))
        assert b == pytest.approx(0.0)


class TestPiecewiseExponential:
    def test_single_piece_matches_exponential(self):
        # one epoch, rate 0.5 from t=2
        u = jnp.array(0.5)
        t = sample_piecewise_exponential(
            u,
            jnp.array(2.0),
            jnp.array([0.0]),
            jnp.array([3e38]),
            jnp.array([0.5]),
        )
        expected = 2.0 + (-np.log1p(-0.5)) / 0.5
        assert float(t) == pytest.approx(expected, rel=1e-5)

    def test_two_pieces(self):
        # rate 1 on [0,1), rate 2 after; start at 0; x = 3 -> t = 1 + 1
        u = 1.0 - np.exp(-3.0)
        t = sample_piecewise_exponential(
            jnp.array(u),
            jnp.array(0.0),
            jnp.array([0.0, 1.0]),
            jnp.array([1.0, 3e38]),
            jnp.array([1.0, 2.0]),
        )
        assert float(t) == pytest.approx(2.0, rel=1e-4)


class TestLikelihood:
    def test_hand_tree_site(self):
        parent, time, pop, children = hand_tree()
        mu = 0.01
        # pattern: leaf 2 carries derived allele
        alleles = jnp.array([0, 0, 1])
        lik_s, acc = _site_likelihood_one(
            time, children, alleles, jnp.float32(mu), jnp.array([0.5, 0.5])
        )
        lik = lik_s * jnp.exp(acc)
        # brute-force over root & internal states
        p = lambda t: np.exp(-mu * t)
        q = lambda t: 1 - np.exp(-mu * t)

        def joint(x4, x3, l0, l1, l2):
            t03, t13 = 1.0, 1.0
            t34, t24 = 2.0, 3.0
            pr = 0.5
            pr *= p(t34) if x3 == x4 else q(t34)
            pr *= p(t24) if l2 == x4 else q(t24)
            pr *= p(t03) if l0 == x3 else q(t03)
            pr *= p(t13) if l1 == x3 else q(t13)
            return pr

        expected = sum(joint(x4, x3, 0, 0, 1) for x4 in (0, 1) for x3 in (0, 1))
        assert float(lik) == pytest.approx(expected, rel=1e-3)  # f32 exp

    def test_missing_data_site(self):
        parent, time, pop, children = hand_tree()
        alleles = jnp.array([-1, -1, -1])
        lik_s, acc = _site_likelihood_one(
            time, children, alleles, jnp.float32(0.01), jnp.array([0.5, 0.5])
        )
        lik = lik_s * jnp.exp(acc)
        assert float(lik) == pytest.approx(1.0, rel=1e-6)


    @pytest.mark.parametrize("n", [4, 16])
    def test_matches_float64_pruning(self, n):
        """The batched float32 kernel against the float64 numpy pruning
        (kernels/pruning_ref.py) on random coalescent trees: per-node
        rescaling and the expm1 mutation probability keep the log-likelihood
        within 1e-4 even on branches where mu*t is far below float32's
        epsilon.  n=16 takes the kernel's while_loop path."""
        from smcsmc_tpu.kernels.pruning_ref import kernel_max_error

        assert kernel_max_error(n, num_trees=1000, sites=4, seed=n) <= 1e-4


class TestInitialTrees:
    def test_tmrca_n2_constant_ne(self):
        ne = 10000.0
        demo = const_demo(ne, n=2)
        epochs = epochs_from_demography(demo)
        trees = make_initial_trees(
            jax.random.PRNGKey(0), epochs, 20000, jnp.zeros(2, jnp.int32)
        )
        tmrca = np.asarray(trees.time[:, 2])
        # E[TMRCA] for n=2 is 2*Ne generations
        assert tmrca.mean() == pytest.approx(2 * ne, rel=0.05)
        # valid topology
        assert np.all(np.asarray(trees.parent[:, :2]) == 2)
        assert np.all(np.asarray(trees.parent[:, 2]) == -1)

    def test_tree_length_n4(self):
        ne = 10000.0
        demo = const_demo(ne, n=4)
        epochs = epochs_from_demography(demo)
        trees = make_initial_trees(
            jax.random.PRNGKey(1), epochs, 20000, jnp.zeros(4, jnp.int32)
        )
        lens = jax.vmap(total_branch_length)(trees.time, trees.parent)
        # E[L] = 4*Ne * sum_{i=1}^{n-1} 1/i
        expected = 4 * ne * (1 + 1 / 2 + 1 / 3)
        assert np.asarray(lens).mean() == pytest.approx(expected, rel=0.05)

    def test_piecewise_ne(self):
        # Ne changes from 10000 to 1000 at t=5000: TMRCA mass compresses
        demo = Demography(
            change_times=np.array([0.0, 5000.0]),
            pop_sizes=np.array([[10000.0], [1000.0]]),
            mig_rates=np.zeros((2, 1, 1)),
            sample_pops=np.zeros(2, dtype=np.int32),
        )
        epochs = epochs_from_demography(demo)
        trees = make_initial_trees(
            jax.random.PRNGKey(2), epochs, 20000, jnp.zeros(2, jnp.int32)
        )
        tmrca = np.asarray(trees.time[:, 2])
        # P(T > 5000) = exp(-5000/20000); E[T | T>5000] = 5000 + 2000
        p_tail = np.exp(-5000 / 20000)
        expected = (
            (1 - p_tail) * (20000 - (5000 * p_tail) / (1 - p_tail) * 0 + 0)
            # E[T | T<5000] for exp(rate 1/20000) truncated:
        )
        # simpler: overall mean = int_0^5000 t f dt + tail
        lam = 1 / 20000
        mean_trunc = (1 / lam) - (5000 + 1 / lam) * np.exp(-lam * 5000)
        expected = mean_trunc + np.exp(-lam * 5000) * (5000 + 2 * 1000)
        assert tmrca.mean() == pytest.approx(expected, rel=0.05)


class TestTransition:
    def test_invariance_constant_ne(self):
        """The clocked SMC' sequence process must leave the coalescent prior
        invariant (the reference's no-data invariance principle,
        test_bias_nodata.py): each particle transitions when its
        Exp(rho*treelen) clock fires within the window."""
        ne = 10000.0
        n = 4
        rho = 1e-8
        window = 5e4  # bp per step; ~0.06 recombinations expected per step
        demo = const_demo(ne, n=n)
        epochs = epochs_from_demography(demo)
        P = 4000
        trees = make_initial_trees(
            jax.random.PRNGKey(3), epochs, P, jnp.zeros(n, jnp.int32)
        )
        key = jax.random.PRNGKey(4)
        tl0 = jax.vmap(total_branch_length)(trees.time, trees.parent)
        next_rec = jax.random.exponential(jax.random.PRNGKey(9), (P,)) / (rho * tl0)

        @jax.jit
        def step(trees, next_rec, key):
            # advance the sweep front by `window`; fire due transitions
            def cond(c):
                _, nr, _ = c
                return jnp.any(nr < window)

            def body(c):
                trees, nr, key = c
                active = nr < window
                key, s1, s2 = jax.random.split(key, 3)
                keys = jax.random.split(s1, P)
                trees, _ = recombination_transition(keys, trees, epochs, active)
                tl = jax.vmap(total_branch_length)(trees.time, trees.parent)
                gap = jax.random.exponential(s2, (P,)) / (rho * tl)
                nr = jnp.where(active, nr + gap, nr)
                return trees, nr, key

            trees, next_rec, key = jax.lax.while_loop(
                cond, body, (trees, next_rec, key)
            )
            return trees, next_rec - window, key

        for _ in range(40):
            trees, next_rec, key = step(trees, next_rec, key)

        lens = jax.vmap(total_branch_length)(trees.time, trees.parent)
        expected = 4 * ne * (1 + 1 / 2 + 1 / 3)
        assert np.asarray(lens).mean() == pytest.approx(expected, rel=0.06)
        # topology sanity: every non-root node's parent is higher
        pt = np.asarray(trees.time)
        par = np.asarray(trees.parent)
        for i in range(2 * n - 1):
            mask = par[:, i] >= 0
            assert np.all(
                pt[mask, par[mask, i]] >= pt[mask, i] - 1e-3
            ), f"node {i} above parent"

    def test_transition_records(self):
        ne = 10000.0
        n = 2
        demo = const_demo(ne, n=n)
        epochs = epochs_from_demography(demo)
        P = 2000
        trees = make_initial_trees(
            jax.random.PRNGKey(5), epochs, P, jnp.zeros(n, jnp.int32)
        )
        keys = jax.random.split(jax.random.PRNGKey(6), P)
        _, rec = recombination_transition(keys, trees, epochs, jnp.ones(P, bool))
        # every particle recorded exactly one recombination and one coalescence
        np.testing.assert_allclose(np.asarray(rec.recomb_cnt).sum(axis=1), 1.0)
        np.testing.assert_allclose(
            np.asarray(rec.coal_cnt).sum(axis=(1, 2)), 1.0
        )
        # coal opportunity > 0 and finite
        opp = np.asarray(rec.coal_opp).sum(axis=(1, 2))
        assert np.all(opp > 0)
        assert np.all(np.isfinite(opp))
        # E-step consistency: E[opp / (2 Ne)] ~ E[count] = 1 at stationarity
        assert opp.mean() / (2 * ne) == pytest.approx(1.0, rel=0.1)
