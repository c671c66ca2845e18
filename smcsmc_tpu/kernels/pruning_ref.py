"""Plain float64 numpy reference for the site likelihood.

Felsenstein pruning over the same ``Trees`` arrays that
:func:`~smcsmc_tpu.kernels.likelihood.site_log_likelihood` reads, written
independently of it: internal nodes are visited in order of height (a
child is always lower than its parent) with explicit gathers, in float64
and without rescaling.  Two-state model of the reference
(particle.cpp:625-680): ``p_nomut = exp(-mu * branch_length)``, leaf
alleles 0/1 or -1 (missing, partial [1, 1]), root prior 1/2:1/2 or 1:0."""

from __future__ import annotations

import numpy as np


def site_log_likelihood_ref(trees, alleles, mutation_rate: float,
                            ancestral_aware: bool = False) -> np.ndarray:
    """[P] float64 log-likelihood of one site pattern under every tree."""
    time = np.asarray(trees.time, np.float64)
    parent = np.asarray(trees.parent)
    child0 = np.asarray(trees.child0)
    child1 = np.asarray(trees.child1)
    alleles = np.asarray(alleles)
    P, N = time.shape
    n = (N + 1) // 2
    rows = np.arange(P)

    partial = np.zeros((P, N, 2))
    partial[:, :n, 0] = alleles != 1
    partial[:, :n, 1] = alleles != 0

    def up(child, node):
        """Partial of ``child`` carried up its branch to ``node``."""
        q = -np.expm1(-mutation_rate * (time[rows, node] - time[rows, child]))
        a = partial[rows, child]  # [P, 2]
        return (1.0 - q)[:, None] * a + q[:, None] * a[:, ::-1]

    order = n + np.argsort(time[:, n:], axis=1, kind="stable")  # [P, n-1]
    for k in range(n - 1):
        node = order[:, k]
        partial[rows, node] = (
            up(child0[rows, node], node) * up(child1[rows, node], node)
        )
    root = np.argmax(parent < 0, axis=1)
    prior = np.array([1.0, 0.0]) if ancestral_aware else np.array([0.5, 0.5])
    return np.log(partial[rows, root] @ prior)


def kernel_max_error(n: int, num_trees: int, sites: int, seed: int,
                     mutation_rate: float = 1e-8) -> float:
    """Largest |log-likelihood| difference between the float32 kernel
    (``site_log_likelihood``) and :func:`site_log_likelihood_ref`, over
    ``num_trees`` random coalescent trees with ``n`` leaves (constant Ne
    10,000, 8 epochs) and ``sites`` random site patterns with 20% missing
    leaves, in both ancestral modes.  NaN if the kernel gives a non-finite
    value."""
    import jax
    import jax.numpy as jnp

    from ..demography import Demography
    from .likelihood import site_log_likelihood
    from .tree import epochs_from_demography, make_initial_trees

    E = 8
    demo = Demography(
        change_times=np.concatenate([[0.0], np.logspace(2.5, 5.0, E - 1)]),
        pop_sizes=np.full((E, 1), 10000.0),
        mig_rates=np.zeros((E, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
    )
    trees = make_initial_trees(
        jax.random.PRNGKey(seed), epochs_from_demography(demo), num_trees,
        jnp.zeros(n, jnp.int32), max_mig=0,
    )
    rng = np.random.default_rng(seed)
    worst = 0.0
    for _ in range(sites):
        alleles = rng.integers(0, 2, n)
        alleles[rng.random(n) < 0.2] = -1
        for ancestral in (False, True):
            got = np.asarray(site_log_likelihood(
                trees, jnp.asarray(alleles), mutation_rate, ancestral))
            ref = site_log_likelihood_ref(trees, alleles, mutation_rate,
                                          ancestral)
            if got.shape != ref.shape or not np.all(np.isfinite(got)):
                return float("nan")
            worst = max(worst, float(np.max(np.abs(got - ref))))
    return worst
