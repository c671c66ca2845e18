"""Batched 2-state Felsenstein pruning on array trees.

Model parity with the reference (particle.cpp:625-680): infinite-sites-style
two-state likelihood where ``p_nomut = exp(-mu * branch_length)`` per branch,
leaf states 0/1, missing (-1) scores [1, 1], root prior 1/2:1/2 (or 1:0 for
``ancestral_aware``).  Unphased genotypes (allele code 2) are marginalized
over phase configurations by the caller (particleContainer.cpp:138-224).

Formulation: a *ready-propagation* sweep over the whole particle
population at once — each pass combines every internal node whose two
children already carry partials, entirely with masked elementwise ops and
one-hot child lookups ([P, N, N] compare+select+reduce).  No argsort (the
height order is discovered by data flow), no gathers, and ONE
population-level ``lax.while_loop`` rather than a vmapped scalar loop (see
tree.make_initial_trees).  Passes needed = internal-combine depth of the
deepest tree (~log n for coalescent trees, <= n-1 worst case).

The root combine with the prior is written as an explicit two-term sum,
not a matrix product: a float32 dot may run at reduced (TF32) precision
on GPUs, and the sum has no such path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _site_likelihood_one(
    tree_time: jnp.ndarray,  # [N]
    tree_children: jnp.ndarray,  # [N, 2]
    alleles: jnp.ndarray,  # [n] int: 0/1/-1 (2 handled by caller)
    mutation_rate: jnp.ndarray,
    ancestral_prior: jnp.ndarray,  # [2]
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Single-tree pruning; returns (rescaled root likelihood, log-scale).

    Ready-propagation with a STATIC n-1 pass fori_loop, so that under vmap
    it needs no per-lane loop masking."""
    N = tree_time.shape[0]
    n = (N + 1) // 2
    l0 = jnp.where(alleles == 1, 0.0, 1.0)
    l1 = jnp.where(alleles == 0, 0.0, 1.0)
    partial = jnp.stack(
        [jnp.concatenate([l0, jnp.zeros(n - 1)]),
         jnp.concatenate([l1, jnp.zeros(n - 1)])], axis=1
    )  # [N, 2]
    is_leaf = tree_children[:, 0] < 0
    eq = jnp.arange(N)
    c0, c1 = tree_children[:, 0], tree_children[:, 1]
    oh0 = c0[:, None] == eq[None, :]
    oh1 = c1[:, None] == eq[None, :]
    t0 = tree_time - jnp.sum(jnp.where(oh0, tree_time[None, :], 0.0), axis=1)
    t1 = tree_time - jnp.sum(jnp.where(oh1, tree_time[None, :], 0.0), axis=1)
    # mutation probability on each child branch; expm1, not 1 - exp: mu*t
    # reaches 1e-8 and below, where 1 - exp loses every digit in float32
    q0 = -jnp.expm1(-t0 * mutation_rate)
    q1 = -jnp.expm1(-t1 * mutation_rate)

    def body(_, s):
        partial, acc, ready = s
        a0 = jnp.sum(jnp.where(oh0[:, :, None], partial[None], 0.0), axis=1)
        a1 = jnp.sum(jnp.where(oh1[:, :, None], partial[None], 0.0), axis=1)
        r0 = jnp.sum(jnp.where(oh0, ready[None, :], False), axis=1) > 0
        r1 = jnp.sum(jnp.where(oh1, ready[None, :], False), axis=1) > 0
        can = (~ready) & ~is_leaf & r0 & r1
        m0 = a0 * (1.0 - q0)[:, None] + a0[:, ::-1] * q0[:, None]
        m1 = a1 * (1.0 - q1)[:, None] + a1[:, ::-1] * q1[:, None]
        val = m0 * m1
        sc = jnp.maximum(jnp.maximum(val[:, 0], val[:, 1]), 1e-30)
        partial = jnp.where(can[:, None], val / sc[:, None], partial)
        acc = acc + jnp.sum(jnp.where(can, jnp.log(sc), 0.0))
        return partial, acc, ready | can

    partial, acc, ready = jax.lax.fori_loop(
        0, n - 1, body, (partial, jnp.float32(0.0), is_leaf)
    )
    # root = the highest node (a complete tree has exactly one)
    root_oh = tree_time == jnp.max(jnp.where(ready, tree_time, -jnp.inf))
    # guard duplicates (tie on max height cannot happen for valid trees)
    root_part = jnp.sum(
        jnp.where(root_oh[:, None], partial, 0.0), axis=0
    ) / jnp.maximum(jnp.sum(root_oh), 1)
    lik = root_part[0] * ancestral_prior[0] + root_part[1] * ancestral_prior[1]
    return lik, acc


def site_log_likelihood(
    trees,
    alleles: jnp.ndarray,
    mutation_rate: float,
    ancestral_aware: bool = False,
) -> jnp.ndarray:
    """[P] per-particle site log-likelihood (particle.cpp:667-680), exact in
    log space via per-node rescaling — no underflow floor at large n (the
    reference computes in double; raw f32 products underflow at n >= ~24)."""
    time, parent = trees.time, trees.parent
    c0, c1 = trees.child0, trees.child1
    P, N = time.shape
    n = (N + 1) // 2
    mu = jnp.float32(mutation_rate)
    prior = jnp.where(
        ancestral_aware, jnp.array([1.0, 0.0]), jnp.array([0.5, 0.5])
    )

    # leaf partials (particle.cpp:632-634): 1 -> [0,1]; 0 -> [1,0];
    # missing -> [1,1]; internal nodes start empty
    l0 = jnp.where(alleles == 1, 0.0, 1.0)
    l1 = jnp.where(alleles == 0, 0.0, 1.0)
    leaf_part = jnp.stack(
        [jnp.concatenate([l0, jnp.zeros(n - 1)]),
         jnp.concatenate([l1, jnp.zeros(n - 1)])], axis=1
    )  # [N, 2]
    partial = jnp.broadcast_to(leaf_part[None], (P, N, 2))
    is_leaf = c0 < 0  # [P, N]
    ready = is_leaf
    eq = jnp.arange(N)

    oh0 = c0[:, :, None] == eq[None, None, :]  # [P, N, N]
    oh1 = c1[:, :, None] == eq[None, None, :]
    t0 = time - jnp.sum(jnp.where(oh0, time[:, None, :], 0.0), axis=2)
    t1 = time - jnp.sum(jnp.where(oh1, time[:, None, :], 0.0), axis=2)
    # [P, N] mutation probability on each child branch (expm1: see
    # _site_likelihood_one)
    q0 = -jnp.expm1(-t0 * mu)
    q1 = -jnp.expm1(-t1 * mu)

    def combine_pass(s):
        partial, acc, ready = s
        a0 = jnp.sum(
            jnp.where(oh0[:, :, :, None], partial[:, None, :, :], 0.0), axis=2
        )  # [P, N, 2]
        a1 = jnp.sum(
            jnp.where(oh1[:, :, :, None], partial[:, None, :, :], 0.0), axis=2
        )
        r0 = jnp.sum(jnp.where(oh0, ready[:, None, :], False), axis=2) > 0
        r1 = jnp.sum(jnp.where(oh1, ready[:, None, :], False), axis=2) > 0
        can = (~ready) & ~is_leaf & r0 & r1
        m0 = a0 * (1.0 - q0)[:, :, None] + a0[:, :, ::-1] * q0[:, :, None]
        m1 = a1 * (1.0 - q1)[:, :, None] + a1[:, :, ::-1] * q1[:, :, None]
        val = m0 * m1
        sc = jnp.maximum(jnp.maximum(val[:, :, 0], val[:, :, 1]), 1e-30)
        partial = jnp.where(
            can[:, :, None], val / sc[:, :, None], partial
        )
        acc = acc + jnp.sum(jnp.where(can, jnp.log(sc), 0.0), axis=1)
        return partial, acc, ready | can

    s = (partial, jnp.zeros((P,)), ready)
    if n <= 8:
        # static unroll: n-1 passes, no data-dependent loop condition (the
        # per-pass reduce for the cond costs more than the spare passes)
        for _ in range(n - 1):
            s = combine_pass(s)
        partial, acc, _ = s
    else:
        def cond(sit):
            (_, _, ready), it = sit
            return jnp.any(~ready) & (it < n)

        def body(sit):
            s, it = sit
            return combine_pass(s), it + 1

        (partial, acc, _), _ = jax.lax.while_loop(
            cond, body, (s, jnp.int32(0))
        )
    root_part = jnp.sum(
        jnp.where((parent < 0)[:, :, None], partial, 0.0), axis=1
    )  # [P, 2]
    lik = root_part[:, 0] * prior[0] + root_part[:, 1] * prior[1]
    return jnp.log(jnp.maximum(lik, 1e-30)) + acc


def site_likelihood(
    trees,
    alleles: jnp.ndarray,
    mutation_rate: float,
    ancestral_aware: bool = False,
) -> jnp.ndarray:
    """[P] per-particle site likelihood (linear space; may underflow for
    large n — prefer :func:`site_log_likelihood` in weight updates)."""
    return jnp.exp(
        site_log_likelihood(trees, alleles, mutation_rate, ancestral_aware)
    )


def phase_configurations(alleles: jnp.ndarray, max_unphased_pairs: int):
    """Host-side helper: enumerate phase configurations for a site with
    unphased genotypes (allele code 2 marks both members of an unphased
    heterozygous pair; reference particleContainer.cpp:138-181).

    Returns an array [C, n] of phased allele vectors (0/1/-1) to average
    over; C = 2^(#unphased het pairs), padded with repeats to a fixed power
    of two so shapes stay static under jit.
    """
    import numpy as np

    alleles = np.asarray(alleles)
    n = len(alleles)
    pair_idx = [i for i in range(0, n - 1, 2) if alleles[i] == 2]
    base = alleles.copy()
    for i in pair_idx:
        base[i], base[i + 1] = 0, 1
    configs = [base]
    for i in pair_idx:
        new = []
        for c in configs:
            flipped = c.copy()
            flipped[i], flipped[i + 1] = c[i + 1], c[i]
            new.append(flipped)
        configs += new
    cmax = 2 ** max_unphased_pairs
    while len(configs) < cmax:
        configs.append(configs[0])
    return np.stack(configs[:cmax]), len(pair_idx)
