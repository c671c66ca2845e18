"""SMC' recombination transition kernel, batched over particles.

Replaces the reference's pointer-walking proposal
(scrm ``Forest::sampleNextGenealogy``; its event logic is spelled out in the
trial-sampling replica at /root/reference/src/particle.cpp:1266-1488) with a
fixed-shape, fully vectorized formulation:

1. sample a recombination point (node ``c``, height ``h_r``) uniformly on the
   local tree (reference ``samplePoint``, particle.cpp:1060; bias weighting
   enters here);
2. the lineage above the cut re-coalesces with the *original* tree: the
   coalescence intensity at time t is ``k_same_pop(t) / (2 Ne_pop(t))`` where
   k counts branches crossing t in the lineage's population (incl. the
   root's ancestral lineage); landing back on the detached segment of c's own
   branch regenerates the same tree — exactly the SMC' transition (the
   lineage count of the original and the spliced tree agree everywhere except
   on the detached segment);
3. the topology update is a constant-time SPR on the index arrays, including
   splitting/merging of per-branch migration-event buffers.

Three walk implementations:
- migration-free (incl. -ej splits via the epoch pop_map): a single
  piecewise-hazard inversion — no sequential loop at all (``_walk_fast``);
- with continuous migration, jump-to-event (the default,
  ``_walk_mig_jump``): the lineage migration paths are pre-simulated as
  cheap scalar CTMCs (migration rates depend only on epoch and current
  population, never on the tree), after which the coalescence time is one
  fixed-shape piecewise-hazard inversion conditional on the paths — the
  factorization is exact because migration is independent of the
  coalescence clock until absorption;
- with continuous migration, lock-step event walk (``_walk_mig_batched``,
  selectable via ``SMCSMC_MIG_WALK=loop``): one ``lax.while_loop``
  iteration per event/breakpoint over the whole population — the original
  formulation, kept as the A/B reference; its population-max iteration
  count made it op-chain-latency-bound (~70x the plain path per
  particle-site).

Opportunity/event records (reference: particle.cpp:193-302,
coalevent.hpp:209-244): coalescence opportunity = Σ pieces k_same·dt,
migration opportunity = Σ dt, migration events per (from,to), all scattered
into [E, Pp(,Pp)] tensors.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .tree import (
    INF,
    Epochs,
    Trees,
    branch_lengths,
    branch_pop_at,
    parent_time,
    sample_piecewise_exponential,
)


class TransitionRecord(NamedTuple):
    """Per-particle sufficient-statistic increments from one transition."""

    coal_opp: jnp.ndarray  # [E, Pp]
    coal_cnt: jnp.ndarray  # [E, Pp]
    mig_opp: jnp.ndarray  # [E, Pp]
    mig_cnt: jnp.ndarray  # [E, Pp, Pp]
    recomb_cnt: jnp.ndarray  # [E]
    recomb_height: jnp.ndarray  # scalar h_r
    coal_height: jnp.ndarray  # scalar t_c
    log_iw: jnp.ndarray  # scalar: log importance weight of the biased point
    log_iw_bias: jnp.ndarray  # scalar: height-bias-only part of log_iw
    point_strength: jnp.ndarray  # bias strength at the sampled point
    c_node: jnp.ndarray  # recombining node (for ARG recording)
    d_node: jnp.ndarray  # coalescence target node (ARG C-row descendants)
    coal_pop: jnp.ndarray  # population of the coalescence
    walk_capped: jnp.ndarray  # scalar: 1 if the migration walk hit its bound
    buf_dropped: jnp.ndarray  # scalar: migration events dropped on overflow
    # realized migration events on the new branch, for the ARG's M rows
    # (particleContainer.cpp:541-547); None without migration
    mig_ev_t: jnp.ndarray = None  # [P, 2*Mw] event times, INF-padded
    mig_ev_from: jnp.ndarray = None  # [P, 2*Mw] source pop of each hop
    mig_ev_to: jnp.ndarray = None  # [P, 2*Mw] destination pop


def _epoch_index(epoch_start: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Epoch of time(s) t via comparison-count, not a batched
    searchsorted (which lowers to per-element gathers)."""
    E = epoch_start.shape[0]
    cnt = jnp.sum(
        t[..., None] >= epoch_start.reshape((1,) * t.ndim + (E,)), axis=-1
    )
    return jnp.clip(cnt - 1, 0, E - 1).astype(jnp.int32)


def _oh_pick(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """table[idx] for a scalar idx into axis 0 as a one-hot reduction that
    fuses into compare+select+reduce instead of a batched gather.  Works for
    any trailing shape."""
    K = table.shape[0]
    oh = (jnp.arange(K) == idx).reshape((K,) + (1,) * (table.ndim - 1))
    return jnp.sum(jnp.where(oh, table, jnp.zeros_like(table)), axis=0)


def _sample_recomb_point(key, tree_time, tree_parent):
    """Uniform point on the local tree: returns (node c, height h_r).
    Gather-free: first-hit selection by comparison instead of searchsorted."""
    bl = branch_lengths(tree_time, tree_parent)
    cum = jnp.cumsum(bl)
    total = cum[-1]
    u = jax.random.uniform(key, (), minval=1e-7, maxval=1.0 - 1e-7)
    x = u * total
    hit = cum >= x  # first true == searchsorted(cum, x, side='left')
    c = jnp.argmax(hit).astype(jnp.int32)
    c = jnp.where(jnp.any(hit), c, bl.shape[0] - 1)
    prev = _oh_pick(cum, c) - _oh_pick(bl, c)
    h_r = _oh_pick(tree_time, c) + (x - prev)
    return c, h_r


def guide_branch_rates(
    tree_time: jnp.ndarray,
    tree_parent: jnp.ndarray,
    tree_child0: jnp.ndarray,
    tree_child1: jnp.ndarray,
    leaf_rates: jnp.ndarray,
) -> jnp.ndarray:
    """[N] relative guide rate on the branch above each node, built bottom-up
    from per-leaf relative rates (reference sampleOrMeasureWeightedTree,
    particle.cpp:972-1018): leaves carry their guide rate, internal branches
    the arithmetic mean of their children's, and the two root-child branches
    both carry the max of the pair (particle.cpp:1087-1094)."""
    N = tree_time.shape[0]
    n = (N + 1) // 2
    r = jnp.concatenate([leaf_rates.astype(jnp.float32), jnp.zeros(n - 1)])
    order = jnp.argsort(tree_time[n:]) + n  # internal nodes, lowest first
    eq = jnp.arange(N)

    def up(r, v):
        c0 = jnp.sum(jnp.where(eq == v, tree_child0, 0))
        c1 = jnp.sum(jnp.where(eq == v, tree_child1, 0))
        return jnp.where(eq == v, 0.5 * (r[c0] + r[c1]), r), None

    if n <= 8:
        for i in range(n - 1):
            r, _ = up(r, order[i])
    else:
        r, _ = jax.lax.scan(up, r, order)
    root = order[n - 2] if n > 1 else jnp.int32(0)
    rc0 = jnp.sum(jnp.where(eq == root, tree_child0, 0))
    rc1 = jnp.sum(jnp.where(eq == root, tree_child1, 0))
    mx = jnp.maximum(r[rc0], r[rc1])
    r = jnp.where((eq == rc0) | (eq == rc1), mx, r)
    return r


def _sample_recomb_point_biased(
    key, tree_time, tree_parent, bias_heights, bias_strengths,
    branch_rates=None,
):
    """Height-biased (and optionally guide-weighted) point sampling
    (reference: samplePoint + sampleOrMeasureWeightedTree /
    accumulateBranchLengths, particle.cpp:942-1126): the sampling density on
    the tree is ``strength(section(y)) * branch_rate(y) / weighted_length``
    instead of ``1/length``.

    bias_heights: [S+1] section boundaries (last = INF);
    bias_strengths: [S] per-section weights;
    branch_rates: [N] per-branch relative guide rates (1.0 = no guiding).

    Returns (c, h_r, log_iw, strength, log_iw_bias) where log_iw is the full
    importance weight ``target_density/sampled_density``, and log_iw_bias its
    height-bias-only part (computed against the bias-only weighted length,
    particle.cpp:1068-1073,1113-1121) — the reference applies the bias part
    immediately when the focal height falls in an unbiased section and delays
    the rest (particle.cpp:874-891).
    """
    N = tree_time.shape[0]
    S = bias_strengths.shape[0]
    pt = parent_time(tree_time, tree_parent)
    lo = jnp.maximum(tree_time[:, None], bias_heights[None, :-1])  # [N, S]
    hi = jnp.minimum(pt[:, None], bias_heights[None, 1:])
    seg = jnp.clip(hi - lo, 0.0, None)
    seg = jnp.where(tree_parent[:, None] < 0, 0.0, seg)
    wseg_bias = seg * bias_strengths[None, :]
    if branch_rates is not None:
        wseg = wseg_bias * branch_rates[:, None]
    else:
        wseg = wseg_bias
    flat_w = wseg.reshape(-1)
    cum = jnp.cumsum(flat_w)
    weighted_total = cum[-1]
    plain_total = jnp.sum(seg)
    u = jax.random.uniform(key, (), minval=1e-7, maxval=1.0 - 1e-7)
    x = u * weighted_total
    idx = jnp.clip(jnp.searchsorted(cum, x, side="left"), 0, N * S - 1)
    c = (idx // S).astype(jnp.int32)
    s = idx % S
    prev = jnp.where(idx > 0, cum[jnp.maximum(idx - 1, 0)], 0.0)
    strength = bias_strengths[s]
    local_w = strength
    if branch_rates is not None:
        local_w = strength * branch_rates[c]
    h_r = lo[c, s] + (x - prev) / jnp.maximum(local_w, 1e-30)
    # full IW = (1/L) / (local_w/WL_full)
    log_iw = (
        jnp.log(weighted_total)
        - jnp.log(jnp.maximum(plain_total, 1e-30))
        - jnp.log(jnp.maximum(local_w, 1e-30))
    )
    if branch_rates is not None:
        wtot_bias = jnp.sum(wseg_bias)
        log_iw_bias = (
            jnp.log(wtot_bias)
            - jnp.log(jnp.maximum(plain_total, 1e-30))
            - jnp.log(jnp.maximum(strength, 1e-30))
        )
    else:
        log_iw_bias = log_iw
    return c, h_r, log_iw, strength, log_iw_bias


# ---------------------------------------------------------------------------
# re-coalescence walks
# ---------------------------------------------------------------------------


def _walk_fast(key, time, parent, pop, c, h_r, epochs: Epochs):
    """Migration-free re-coalescence: single piecewise-hazard inversion.

    Sort-free and gather-free: the cumulative hazard Λ(t) of the structured
    coalescent (rate k_same(t) / 2Ne(t), piecewise linear in t) is evaluated
    directly at every UNSORTED breakpoint candidate (node times ∪ epoch
    starts) as a [V, N, E] elementwise tensor; the event time inverts
    Λ(t*) = x by taking the highest breakpoint with Λ ≤ x plus a linear
    step at the local rate, with no sort of the breakpoints, no
    searchsorted and no index gathers."""
    N = parent.shape[0]
    E, Pp = epochs.num_epochs, epochs.num_pops
    k_coal, k_tgt = jax.random.split(key)
    end = epochs.end  # [E]

    # parent_time as a one-hot reduction (gather-free)
    pt = jnp.where(
        parent[:, None] == jnp.arange(N)[None, :], time[None, :], 0.0
    ).sum(axis=1)
    pt = jnp.where(parent < 0, INF, pt)

    # branch populations per epoch under -ej folding: mapped[e, b]
    oh_pop = pop[None, :] == jnp.arange(Pp)[:, None]  # [Pp, N]
    mapped = jnp.sum(
        jnp.where(oh_pop[None, :, :], epochs.pop_map[:, :, None], 0), axis=1
    )  # [E, N]
    pop_c = jnp.sum(jnp.where(jnp.arange(N) == c, pop, 0))
    fpop_e = _oh_pick(epochs.pop_map.T, pop_c)  # [E] floating pop per epoch
    same = mapped == fpop_e[:, None]  # [E, N]
    ne_e = jnp.sum(
        jnp.where(fpop_e[:, None] == jnp.arange(Pp)[None, :], epochs.ne, 0.0),
        axis=1,
    )  # [E] Ne of the floating lineage's population per epoch
    inv2ne = 1.0 / (2.0 * ne_e)  # [E]

    def big_lambda(t):
        """Cumulative hazard over [h_r, t]: Σ_b Σ_e same·overlap/(2Ne_e)."""
        lo = jnp.maximum(time[None, :], jnp.maximum(epochs.start[:, None], h_r))
        hi = jnp.minimum(pt[None, :], jnp.minimum(end[:, None], t))
        ov = jnp.clip(hi - lo, 0.0, None)  # [E, N]
        return jnp.sum(jnp.where(same, ov, 0.0) * inv2ne[:, None])

    # breakpoint candidates (unsorted): node times + epoch starts
    v = jnp.concatenate([time, epochs.start])  # [V]
    lo_v = jnp.maximum(
        time[None, None, :], jnp.maximum(epochs.start[None, :, None], h_r)
    )  # [1, E, N]
    hi_v = jnp.minimum(
        pt[None, None, :],
        jnp.minimum(end[None, :, None], v[:, None, None]),
    )  # [V, E, N]
    ov_v = jnp.clip(hi_v - lo_v, 0.0, None)
    lam_v = jnp.sum(
        jnp.where(same[None], ov_v, 0.0) * inv2ne[None, :, None], axis=(1, 2)
    )  # [V] Λ at each candidate

    u = jax.random.uniform(k_coal, (), minval=1e-7, maxval=1.0 - 1e-7)
    x = -jnp.log1p(-u)  # Exp(1) target

    # highest breakpoint not exceeding the target hazard (and >= h_r)
    t_lo = jnp.max(jnp.where(lam_v <= x, v, -INF))
    t_lo = jnp.maximum(t_lo, h_r)
    lam_lo = big_lambda(t_lo)
    # local rate on [t_lo, next breakpoint): right-continuous evaluation
    e_lo = _epoch_index(epochs.start, t_lo)
    same_lo = _oh_pick(same, e_lo).astype(bool)  # [N]
    k_lo = jnp.sum(
        jnp.where((time <= t_lo) & (t_lo < pt) & same_lo, 1.0, 0.0)
    )
    rate_lo = k_lo * _oh_pick(inv2ne, e_lo)
    t_c = t_lo + jnp.where(
        rate_lo > 0, (x - lam_lo) / jnp.maximum(rate_lo, 1e-30), INF
    )
    t_c = jnp.minimum(t_c, jnp.float32(0.99 * INF))

    e_c = _epoch_index(epochs.start, t_c)
    fpop_c = jnp.sum(jnp.where(jnp.arange(E) == e_c, fpop_e, 0))
    same_c = _oh_pick(same, e_c).astype(bool)
    cross_c = (time <= t_c) & (t_c < pt) & same_c
    kc = jnp.sum(cross_c)
    r = jax.random.randint(k_tgt, (), 0, jnp.maximum(kc, 1))
    csum = jnp.cumsum(cross_c.astype(jnp.int32)) - 1
    d = jnp.argmax((csum == r) & cross_c).astype(jnp.int32)

    # opportunity records over [h_r, t_c] (coalevent.hpp:209-244)
    lo_o = jnp.maximum(time[None, :], jnp.maximum(epochs.start[:, None], h_r))
    hi_o = jnp.minimum(pt[None, :], jnp.minimum(end[:, None], t_c))
    ov_o = jnp.clip(hi_o - lo_o, 0.0, None)  # [E, N]
    coal_opp_e = jnp.sum(jnp.where(same, ov_o, 0.0), axis=1)  # [E]
    span_e = jnp.clip(
        jnp.minimum(end, t_c) - jnp.maximum(epochs.start, h_r), 0.0, None
    )  # [E] lineage-time per epoch
    oh_fpop = (fpop_e[:, None] == jnp.arange(Pp)[None, :]).astype(
        jnp.float32
    )  # [E, Pp]
    coal_opp = coal_opp_e[:, None] * oh_fpop
    mig_opp = span_e[:, None] * oh_fpop
    coal_cnt = (
        (jnp.arange(E)[:, None] == e_c) & (jnp.arange(Pp)[None, :] == fpop_c)
    ).astype(jnp.float32)
    mig_cnt = jnp.zeros((E, Pp, Pp))
    new_ev_t = None
    new_ev_d = None
    return t_c, d, fpop_c, coal_opp, coal_cnt, mig_opp, mig_cnt, new_ev_t, new_ev_d


def _walk_mig_batched(
    key, time, parent, pop, mig_time, mig_dest, c, h_r,
    epochs: Epochs, max_events: int, active,
):
    """Re-coalescence with continuous migration: bounded event walk over the
    whole particle population in lock-step ([P, ...] arrays everywhere).

    Below the root, each floating lineage walks against its tree's branches
    (whose populations follow their stored migration events).  Above the root
    the process is the two-lineage pairwise structured coalescent: BOTH the
    floating lineage and the root's ancestral lineage migrate, and they
    coalesce when in the same population (the reference simulates this as
    scrm's two active nodes + PwCoalescence, particle.cpp:1266+ and
    record_all_event's pairwise weight, particle.cpp:257-259).  The ancestral
    path above the root is re-simulated fresh at each transition
    (memoryless), so no migration events are stored above the root.

    One global ``lax.while_loop`` with explicit per-particle done-masking,
    not a vmapped scalar loop (see make_initial_trees)."""
    P, N = parent.shape
    E, Pp = epochs.num_epochs, epochs.num_pops
    Mw = mig_time.shape[2]
    rowid = jnp.arange(P)
    pt = jax.vmap(parent_time)(time, parent)  # [P, N]
    root = jnp.argmax(parent < 0, axis=1).astype(jnp.int32)  # [P]

    # one-hot pickers (gather-free: no batched gathers / take_along_axis)
    def pick_nodes(arr, idx):
        """arr [P, N(, ...)], idx [P] -> arr[p, idx[p]] via one-hot."""
        oh = (jnp.arange(N)[None, :] == idx[:, None])
        oh = oh.reshape(P, N, *([1] * (arr.ndim - 2)))
        return jnp.sum(jnp.where(oh, arr, 0), axis=1)

    def pick_last(val, k):
        """val [P, Mw] (or [P, N, Mw]), k counts -> val[..., k-1] one-hot."""
        oh = jnp.arange(Mw) == (k - 1)[..., None]
        return jnp.sum(jnp.where(oh, val, 0), axis=-1)

    root_h = pick_nodes(time, root)
    # static breakpoints: node times, epoch starts, all branch migration times
    bks = jnp.concatenate(
        [time, jnp.broadcast_to(epochs.start, (P, E)),
         mig_time.reshape(P, -1)],
        axis=1,
    )  # [P, N+E+N*Mw]

    # per-epoch lookup tables (small [E, ...] -> picked via [P, E] one-hots)
    pop_map_i = epochs.pop_map.astype(jnp.int32)  # [E, Pp]
    tot_mig = jnp.sum(epochs.mig, axis=2)  # [E, Pp]
    arangePp = jnp.arange(Pp)

    # the floating lineage starts in branch c's population AT the cut height
    # (after c's own migration events below h_r)
    mt_c = pick_nodes(mig_time, c)  # [P, Mw]
    md_c = pick_nodes(mig_dest, c)
    k0 = jnp.sum(mt_c <= h_r[:, None], axis=1)
    p_raw0 = jnp.where(k0 > 0, pick_last(md_c, k0), pick_nodes(pop, c))

    init = dict(
        key=key,
        t=h_r,
        p_raw=p_raw0,
        r_raw=pick_nodes(pop, root),  # root lineage pop (pairwise phase)
        done=~active,
        t_c=jnp.zeros((P,)),
        d=jnp.full((P,), -1, jnp.int32),
        fpop_c=jnp.zeros((P,), jnp.int32),
        coal_opp=jnp.zeros((P, E, Pp)),
        coal_cnt=jnp.zeros((P, E, Pp)),
        mig_opp=jnp.zeros((P, E, Pp)),
        mig_cnt=jnp.zeros((P, E, Pp, Pp)),
        ev_t=jnp.full((P, 2 * Mw), INF),
        ev_d=jnp.zeros((P, 2 * Mw), jnp.int32),
        n_ev=jnp.zeros((P,), jnp.int32),
        rev_t=jnp.full((P, 2 * Mw), INF),  # root-lineage events
        rev_d=jnp.zeros((P, 2 * Mw), jnp.int32),
        n_rev=jnp.zeros((P,), jnp.int32),
        it=jnp.int32(0),
    )

    def cond(s):
        return jnp.any(~s["done"]) & (s["it"] < max_events)

    def body(s):
        key, k1, k2, k3, k4 = jax.random.split(s["key"], 5)
        go = ~s["done"]
        t = s["t"]
        e = _epoch_index(epochs.start, t)  # [P]
        oh_e = e[:, None] == jnp.arange(E)[None, :]  # [P, E]
        pm = jnp.sum(
            jnp.where(oh_e[:, :, None], pop_map_i[None], 0), axis=1
        )  # [P, Pp] current epoch's population fold
        oh_praw = s["p_raw"][:, None] == arangePp[None, :]  # [P, Pp]
        oh_rraw = s["r_raw"][:, None] == arangePp[None, :]
        p_cur = jnp.sum(jnp.where(oh_praw, pm, 0), axis=1)
        r_cur = jnp.sum(jnp.where(oh_rraw, pm, 0), axis=1)
        oh_pcur = p_cur[:, None] == arangePp[None, :]  # [P, Pp]
        oh_rcur = r_cur[:, None] == arangePp[None, :]
        above_root = t >= root_h
        # branch populations at time t (batched branch_pop_at)
        k_ev = jnp.sum(mig_time <= t[:, None, None], axis=2)  # [P, N]
        last = jnp.where(k_ev > 0, pick_last(mig_dest, k_ev), pop)  # [P, N]
        bp = jnp.sum(
            jnp.where(last[:, :, None] == arangePp[None, None, :],
                      pm[:, None, :], 0),
            axis=2,
        )  # [P, N]
        # the root's ancestral lineage population is dynamic state
        bp = jnp.where(jnp.arange(N)[None, :] == root[:, None],
                       r_cur[:, None], bp)
        crossing = (time <= t[:, None]) & (t[:, None] < pt)  # [P, N]
        cand = crossing & (bp == p_cur[:, None])
        k_same = jnp.sum(cand, axis=1).astype(jnp.float32)  # [P]
        ne_row = jnp.sum(
            jnp.where(oh_e[:, :, None], epochs.ne[None], 0.0), axis=1
        )  # [P, Pp]
        ne_cur = jnp.sum(jnp.where(oh_pcur, ne_row, 0.0), axis=1)
        coal_rate = k_same / (2.0 * ne_cur)
        totmig_row = jnp.sum(
            jnp.where(oh_e[:, :, None], tot_mig[None], 0.0), axis=1
        )  # [P, Pp]
        mig_rate = jnp.sum(jnp.where(oh_pcur, totmig_row, 0.0), axis=1)
        root_mig_rate = jnp.where(
            above_root,
            jnp.sum(jnp.where(oh_rcur, totmig_row, 0.0), axis=1),
            0.0,
        )
        total = coal_rate + mig_rate + root_mig_rate
        t_bk = jnp.min(jnp.where(bks > t[:, None], bks, INF), axis=1)
        u = jax.random.uniform(k1, (P,), minval=1e-7, maxval=1.0 - 1e-7)
        dt = jnp.where(
            total > 0, -jnp.log1p(-u) / jnp.maximum(total, 1e-30), INF
        )
        hit_bk = t + dt >= t_bk
        t_next = jnp.minimum(t + dt, t_bk)
        # opportunity over [t, t_next): floating lineage always; root lineage
        # in the pairwise phase (both active nodes record, particle.cpp:251+)
        span = jnp.clip(t_next - t, 0.0, None)
        span = jnp.where(jnp.isfinite(span) & go, span, 0.0)
        # one-hot masked adds instead of batched scatters
        oh_e = (e[:, None] == jnp.arange(E)[None, :]).astype(jnp.float32)
        oh_p = (p_cur[:, None] == jnp.arange(Pp)[None, :]).astype(jnp.float32)
        oh_r = (r_cur[:, None] == jnp.arange(Pp)[None, :]).astype(jnp.float32)
        oh_ep = oh_e[:, :, None] * oh_p[:, None, :]  # [P, E, Pp]
        coal_opp = s["coal_opp"] + oh_ep * (k_same * span)[:, None, None]
        mig_opp = s["mig_opp"] + oh_ep * span[:, None, None]
        mig_opp = mig_opp + (oh_e[:, :, None] * oh_r[:, None, :]) * jnp.where(
            above_root, span, 0.0
        )[:, None, None]

        # --- event choice --------------------------------------------------
        x = jax.random.uniform(k2, (P,)) * total
        is_coal = go & ~hit_bk & (x < coal_rate)
        is_float_mig = go & ~hit_bk & ~is_coal & (x < coal_rate + mig_rate)
        is_root_mig = go & ~hit_bk & ~is_coal & ~is_float_mig

        # coalescence lane: pick a uniform candidate branch
        kc = jnp.sum(cand, axis=1)
        r = jnp.floor(
            jax.random.uniform(k3, (P,)) * jnp.maximum(kc, 1)
        ).astype(jnp.int32)
        csum = jnp.cumsum(cand.astype(jnp.int32), axis=1) - 1
        d_new = jnp.argmax((csum == r[:, None]) & cand, axis=1).astype(
            jnp.int32
        )
        coal_cnt = s["coal_cnt"] + oh_ep * is_coal.astype(jnp.float32)[
            :, None, None
        ]

        # migration lanes: sample destination for whichever lineage moves
        mover = jnp.where(is_root_mig, r_cur, p_cur)
        oh_mover = mover[:, None] == arangePp[None, :]  # [P, Pp]
        mig_row = jnp.sum(
            oh_e[:, :, None, None] * epochs.mig[None], axis=1
        )  # [P, Pp, Pp] (oh_e here is the float opportunity one-hot)
        w = jnp.sum(jnp.where(oh_mover[:, :, None], mig_row, 0.0), axis=1)
        dest = jax.random.categorical(
            k4, jnp.log(jnp.maximum(w, 1e-30)), axis=-1
        ).astype(jnp.int32)
        any_mig = is_float_mig | is_root_mig
        oh_m = (mover[:, None] == jnp.arange(Pp)[None, :]).astype(jnp.float32)
        oh_d = (dest[:, None] == jnp.arange(Pp)[None, :]).astype(jnp.float32)
        mig_cnt = s["mig_cnt"] + (
            any_mig.astype(jnp.float32)[:, None, None, None]
            * oh_e[:, :, None, None]
            * oh_m[:, None, :, None]
            * oh_d[:, None, None, :]
        )

        def push(ev_t, ev_d, n_ev, mask):
            slot = jnp.minimum(n_ev, 2 * Mw - 1)
            hit = (jnp.arange(2 * Mw)[None, :] == slot[:, None]) & mask[:, None]
            ev_t = jnp.where(hit, t_next[:, None], ev_t)
            ev_d = jnp.where(hit, dest[:, None], ev_d)
            return ev_t, ev_d, n_ev + mask.astype(jnp.int32)

        ev_t, ev_d, n_ev = push(s["ev_t"], s["ev_d"], s["n_ev"], is_float_mig)
        rev_t, rev_d, n_rev = push(
            s["rev_t"], s["rev_d"], s["n_rev"], is_root_mig
        )

        return dict(
            key=key,
            t=jnp.where(go, t_next, t),
            p_raw=jnp.where(is_float_mig, dest, s["p_raw"]),
            r_raw=jnp.where(is_root_mig, dest, s["r_raw"]),
            done=s["done"] | is_coal,
            t_c=jnp.where(is_coal, t_next, s["t_c"]),
            d=jnp.where(is_coal, d_new, s["d"]),
            fpop_c=jnp.where(is_coal, p_cur, s["fpop_c"]),
            coal_opp=coal_opp,
            coal_cnt=coal_cnt,
            mig_opp=mig_opp,
            mig_cnt=mig_cnt,
            ev_t=ev_t,
            ev_d=ev_d,
            n_ev=n_ev,
            rev_t=rev_t,
            rev_d=rev_d,
            n_rev=n_rev,
            it=s["it"] + 1,
        )

    s = jax.lax.while_loop(cond, body, init)
    # if the walk hit the iteration cap without coalescing, coalesce onto the
    # root lineage at the current time (guarded fallback; should not happen
    # for sane models)
    ok = s["done"] | ~active
    d = jnp.where(ok, s["d"], root)
    t_c = jnp.where(
        ok, s["t_c"], jnp.maximum(s["t"], jnp.max(time, axis=1))
    )
    # the new root's population when coalescing with the ancestral lineage
    fpop_c = jnp.where(ok, s["fpop_c"], s["r_raw"])
    capped = (~ok).astype(jnp.float32)  # [P] walk hit max_events (observability)
    return (
        t_c,
        d,
        fpop_c,
        p_raw0,
        s["coal_opp"],
        s["coal_cnt"],
        s["mig_opp"],
        s["mig_cnt"],
        s["ev_t"],
        s["ev_d"],
        s["rev_t"],
        s["rev_d"],
        capped,
    )


def _walk_mig_jump(
    key, time, parent, pop, mig_time, mig_dest, c, h_r,
    epochs: Epochs, max_events: int, active,
    max_compact: int = 64, mig_uniform: bool = False,
    mig_jumps: int = 0, mig_compact: int = 0,
):
    """Re-coalescence with continuous migration — jump-to-event formulation.

    Replaces ``_walk_mig_batched``'s lock-step per-event ``while_loop``
    (population-max 40-80 iterations of tiny fused ops — op-chain-latency
    bound) with three fixed-shape stages:

    1. **CTMC paths** (``lax.scan`` over ``Mj`` jumps of [P]-scalar ops):
       migration of the floating lineage and of the root's ancestral lineage
       depends only on (epoch, current population) — never on the tree — so
       both paths can be simulated marginally, ahead of the coalescence
       clock.  Jump times come from a closed-form piecewise-exponential
       inversion over epochs.  This factorization is exact: in the competing
       risks decomposition the migration components are autonomous, and
       sampling them first then the coalescence first-arrival conditional on
       the paths reproduces the joint law (same process the reference walks
       event-by-event, particle.cpp:1266-1488, with scrm's two active nodes
       + PwCoalescence above the root).
    2. **Compact event list**: the K earliest finite branch-migration events
       out of the [N, Mw] buffers via ``top_k`` (buffers are tail-sized,
       nearly all INF-padded).
    3. **One piecewise-hazard inversion** conditional on the paths — the
       ``_walk_fast`` pattern: evaluate the coalescence rate at every
       breakpoint (node times, epoch starts, compact events, path jumps),
       take the highest breakpoint with cumulative hazard <= the Exp(1)
       draw, finish with a linear step.  Per-population lineage counts at
       the breakpoints use a base-plus-delta representation (full counts at
       epoch starts + signed in-epoch jump triples) so no [V, N, Mw]
       broadcast is ever formed.

    Approximation boundary (recorded in ``capped``): lineage paths truncate
    at ``Mj`` jumps and the compact list at K events; a particle is flagged
    only when its coalescence time actually runs past the truncation.
    """
    P, N = parent.shape
    E, Pp = epochs.num_epochs, epochs.num_pops
    Mw = mig_time.shape[2]
    # path-jump and compact-event budgets: auto-sized by the driver from the
    # model's expected event counts (em._auto_mig_sizes); fallback reuses
    # the per-branch buffer capacity Mw (tail-sized by _auto_mig_buffer).
    # Truncation is recorded per particle in ``capped``.  The budgets set
    # the breakpoint-set size V and hence the walk's [P, V, V] / [P, V, T]
    # FLOPs — the dominant cost at P >= 10k.
    K = (
        int(os.environ.get("SMCSMC_MIG_COMPACT", 0))
        or mig_compact
        or int(min(max_compact, N * Mw))
    )
    K = int(min(K, N * Mw))
    Mj = (
        int(os.environ.get("SMCSMC_MIG_JUMPS", 0))
        or mig_jumps
        or int(min(max(24, Mw), max_events))
    )
    BIG = jnp.float32(1e30)
    start, end = epochs.start, epochs.end  # [E]
    pm_i = epochs.pop_map.astype(jnp.int32)  # [E, Pp]
    arangePp = jnp.arange(Pp)
    arangeN = jnp.arange(N)
    arangeE = jnp.arange(E)
    arangeK = jnp.arange(K)

    def pick_nodes(arr, idx):
        oh = arangeN[None, :] == idx[:, None]
        oh = oh.reshape(P, N, *([1] * (arr.ndim - 2)))
        return jnp.sum(jnp.where(oh, arr, 0), axis=1)

    pt = jax.vmap(parent_time)(time, parent)  # [P, N]
    root = jnp.argmax(parent < 0, axis=1).astype(jnp.int32)
    root_h = pick_nodes(time, root)  # [P]
    pop_root = pick_nodes(pop, root)  # [P]
    not_root = arangeN[None, :] != root[:, None]  # [P, N]

    # floating lineage's start label: branch c's label at the cut height
    mt_c = pick_nodes(mig_time, c)  # [P, Mw]
    md_c = pick_nodes(mig_dest, c)
    k0 = jnp.sum(mt_c <= h_r[:, None], axis=1)
    oh_k0 = jnp.arange(Mw)[None, :] == (k0 - 1)[:, None]
    last_c = jnp.sum(jnp.where(oh_k0, md_c, 0), axis=1)
    p_raw0 = jnp.where(k0 > 0, last_c, pick_nodes(pop, c))

    # --- stage 2: compact the branch-event buffers -----------------------
    NM = N * Mw
    flat_b = jnp.broadcast_to(arangeN[:, None], (N, Mw)).reshape(-1)  # [NM]
    # root's ancestral path is re-simulated fresh each walk; drop its row
    flat_t = jnp.where(
        flat_b[None, :] == root[:, None], INF, mig_time.reshape(P, NM)
    )
    flat_d = mig_dest.reshape(P, NM)
    negv, idxk = jax.lax.top_k(-flat_t, K)  # K smallest times
    cev_t = -negv  # [P, K] ascending, INF-padded
    oh_idx = idxk[:, :, None] == jnp.arange(NM)[None, None, :]
    cev_d = jnp.sum(jnp.where(oh_idx, flat_d[:, None, :], 0), axis=2)
    cev_b = jnp.sum(jnp.where(oh_idx, flat_b[None, None, :], 0), axis=2)
    cev_fin = cev_t < 0.5 * INF  # [P, K]
    n_overflow = jnp.sum(flat_t < 0.5 * INF, axis=1) - jnp.sum(cev_fin, axis=1)

    oh_cb = cev_b[:, :, None] == arangeN[None, None, :]  # [P, K, N]
    cev_bpop = jnp.sum(jnp.where(oh_cb, pop[:, None, :], 0), axis=2)
    # label just below each event = dest of the previous event on the branch
    same_b = cev_b[:, :, None] == cev_b[:, None, :]  # [P, K, K]
    earlier = (
        same_b
        & (cev_t[:, None, :] < cev_t[:, :, None])
        & cev_fin[:, None, :]
    )
    jprev = jnp.argmax(jnp.where(earlier, cev_t[:, None, :], -INF), axis=2)
    oh_jp = jprev[:, :, None] == arangeK[None, None, :]
    prev_d = jnp.sum(jnp.where(oh_jp, cev_d[:, None, :], 0), axis=2)
    cev_prev = jnp.where(jnp.any(earlier, axis=2), prev_d, cev_bpop)
    # label at the top of each branch (all stored events lie below pt)
    app_b = cev_fin[:, None, :] & (
        cev_b[:, None, :] == arangeN[None, :, None]
    )  # [P, N, K]
    kx = jnp.argmax(jnp.where(app_b, cev_t[:, None, :], -INF), axis=2)
    ohkx = kx[:, :, None] == arangeK[None, None, :]
    lastd = jnp.sum(jnp.where(ohkx, cev_d[:, None, :], 0), axis=2)
    lab_end = jnp.where(jnp.any(app_b, axis=2), lastd, pop)  # [P, N]

    # --- stage 1: marginal CTMC paths ------------------------------------
    tot_mig = jnp.sum(epochs.mig, axis=2)  # [E, Pp]
    rate_es = jnp.take_along_axis(tot_mig, pm_i, axis=1)  # [E, raw label]

    def ctmc_scan(ck, t0, s0):
        """Mj jumps of the (epoch, label)-dependent migration CTMC for a
        stacked batch of B lineages.  Returns (times [B, Mj] ascending
        INF-padded, dest labels, source folded pops).  All per-step ops are
        [B]- or [B, E]-shaped."""
        B = t0.shape[0]

        def step(carry, kk):
            t, s, dead = carry
            k1, k2 = jax.random.split(kk)
            oh_s = s[:, None] == arangePp[None, :]  # [B, Pp]
            rate_pe = jnp.sum(
                jnp.where(oh_s[:, None, :], rate_es[None], 0.0), axis=2
            )  # [B, E]
            lo = jnp.maximum(start[None, :], t[:, None])
            ln = jnp.clip(
                jnp.minimum(end[None, :], BIG) - jnp.minimum(lo, BIG),
                0.0, None,
            )
            cum = jnp.cumsum(rate_pe * ln, axis=1)
            u = jax.random.uniform(k1, (B,), minval=1e-7, maxval=1.0 - 1e-7)
            x = -jnp.log1p(-u)
            idx = jnp.clip(jnp.sum(cum < x[:, None], axis=1), 0, E - 1)
            oh_i = idx[:, None] == arangeE[None, :]
            prev = jnp.sum(
                jnp.where(arangeE[None, :] == idx[:, None] - 1, cum, 0.0),
                axis=1,
            )
            rate_i = jnp.sum(jnp.where(oh_i, rate_pe, 0.0), axis=1)
            lo_i = jnp.sum(jnp.where(oh_i, lo, 0.0), axis=1)
            t_next = lo_i + jnp.where(
                rate_i > 0, (x - prev) / jnp.maximum(rate_i, 1e-30), BIG
            )
            live = (~dead) & (x <= cum[:, -1]) & (t_next < 0.5 * BIG)
            e_n = _epoch_index(start, t_next)
            oh_en = e_n[:, None] == arangeE[None, :]
            pm_n = jnp.sum(
                jnp.where(oh_en[:, :, None], pm_i[None], 0), axis=1
            )  # [B, Pp]
            p_cur = jnp.sum(jnp.where(oh_s, pm_n, 0), axis=1)
            mig_n = jnp.sum(
                jnp.where(oh_en[:, :, None, None], epochs.mig[None], 0.0),
                axis=1,
            )  # [B, Pp, Pp]
            w = jnp.sum(
                jnp.where(
                    (p_cur[:, None] == arangePp[None, :])[:, :, None],
                    mig_n, 0.0,
                ),
                axis=1,
            )
            dest = jax.random.categorical(
                k2, jnp.log(jnp.maximum(w, 1e-30)), axis=-1
            ).astype(jnp.int32)
            out = (
                jnp.where(live, t_next, INF),
                jnp.where(live, dest, 0),
                jnp.where(live, p_cur, 0),
            )
            return (
                jnp.where(live, t_next, t),
                jnp.where(live, dest, s),
                dead | ~live,
            ), out

        ks = jax.random.split(ck, Mj)
        _, (jt, jd, jfrom) = jax.lax.scan(
            step, (t0, s0, jnp.zeros((B,), bool)), ks
        )
        return jt.T, jd.T, jfrom.T  # [B, Mj]

    def ctmc_uniform(ck, t0, s0):
        """Scan-free path sampler for the uniform-rate two-population case
        (total out-migration rate identical across populations in every
        epoch — the symmetric island/split models of the gates and bench).
        Then jump times are the inverse of ONE shared piecewise-constant
        hazard at the running Exp(1) partial sums (a cumsum + a batched
        epoch-tensor inversion, no sequential dependence), and with Pp == 2
        destinations alternate deterministically.  Exact, not approximate:
        the per-state hazards coincide, and for two populations the
        embedded jump chain has a single destination per state."""
        B = t0.shape[0]
        r_e = rate_es[:, 0]  # [E] shared per-epoch rate
        u = jax.random.uniform(
            ck, (B, Mj), minval=1e-7, maxval=1.0 - 1e-7
        )
        cx = jnp.cumsum(-jnp.log1p(-u), axis=1)  # [B, Mj] target hazards
        lo = jnp.maximum(start[None, :], t0[:, None])  # [B, E]
        ln = jnp.clip(
            jnp.minimum(end[None, :], BIG) - jnp.minimum(lo, BIG), 0.0, None
        )
        cum = jnp.cumsum(r_e[None, :] * ln, axis=1)  # [B, E]
        idx = jnp.clip(
            jnp.sum(cum[:, None, :] < cx[:, :, None], axis=2), 0, E - 1
        )  # [B, Mj]
        oh_i = idx[..., None] == arangeE  # [B, Mj, E]
        prev = jnp.sum(
            jnp.where(arangeE[None, None, :] == idx[..., None] - 1,
                      cum[:, None, :], 0.0),
            axis=2,
        )
        rate_i = jnp.sum(jnp.where(oh_i, r_e[None, None, :], 0.0), axis=2)
        lo_i = jnp.sum(jnp.where(oh_i, lo[:, None, :], 0.0), axis=2)
        jt = lo_i + jnp.where(
            rate_i > 0, (cx - prev) / jnp.maximum(rate_i, 1e-30), BIG
        )
        jt = jnp.where(
            (cx <= cum[:, -1:]) & (jt < 0.5 * BIG), jt, INF
        )  # [B, Mj]
        # states alternate from s0: dest of jump j is the other pop
        par = (s0[:, None] + jnp.arange(1, Mj + 1)[None, :]) % 2
        jd = jnp.where(jt < 0.5 * INF, par.astype(jnp.int32), 0)
        # folded source pop at each jump time
        e_j = _epoch_index(start, jt)
        src = (s0[:, None] + jnp.arange(Mj)[None, :]) % 2  # raw label before
        pm_j = jnp.sum(
            jnp.where((e_j[..., None] == arangeE)[..., None],
                      pm_i[None, None], 0),
            axis=2,
        )  # [B, Mj, Pp]
        jfrom = jnp.sum(
            jnp.where(src[..., None] == arangePp, pm_j, 0), axis=2
        )
        jfrom = jnp.where(jt < 0.5 * INF, jfrom, 0)
        return jt, jd, jfrom

    k_p, k_x, k_d = jax.random.split(key, 3)
    # one stacked [2P] pass: rows 0..P-1 the floating lineage (from the cut
    # height), rows P..2P-1 the root's ancestral lineage (from the root)
    sampler = ctmc_uniform if (mig_uniform and Pp == 2) else ctmc_scan
    jt2, jd2, jfrom2 = sampler(
        k_p,
        jnp.concatenate([h_r, root_h]),
        jnp.concatenate([p_raw0, pop_root]),
    )
    jt_f, jt_r = jt2[:P], jt2[P:]
    jd_f, jd_r = jd2[:P], jd2[P:]
    jfrom_f, jfrom_r = jfrom2[:P], jfrom2[P:]

    # --- per-pop lineage counts: base at epoch starts + signed triples ----
    # folded crossing-count k_base[p, e, pop] evaluated at each epoch start
    app_e = cev_t[:, None, :] <= start[None, :, None]  # [P, E, K]
    m_eb = app_e[:, :, None, :] & (
        cev_b[:, None, None, :] == arangeN[None, None, :, None]
    )  # [P, E, N, K]
    kxx = jnp.argmax(jnp.where(m_eb, cev_t[:, None, None, :], -INF), axis=3)
    ohk2 = kxx[..., None] == arangeK
    ld_e = jnp.sum(jnp.where(ohk2, cev_d[:, None, None, :], 0), axis=3)
    lab_e = jnp.where(jnp.any(m_eb, axis=3), ld_e, pop[:, None, :])
    oh_lab = lab_e[..., None] == arangePp  # [P, E, N, Pp]
    folded_e = jnp.sum(jnp.where(oh_lab, pm_i[None, :, None, :], 0), axis=3)
    cross_e = (
        (time[:, None, :] <= start[None, :, None])
        & (start[None, :, None] < pt[:, None, :])
        & not_root[:, None, :]
    )  # [P, E, N]
    k_base = jnp.sum(
        (cross_e[..., None] & (folded_e[..., None] == arangePp)).astype(
            jnp.float32
        ),
        axis=2,
    )  # [P, E, Pp]

    # in-epoch jump triples: (time, +/-1, raw label)
    ntime = jnp.where(not_root, time, INF)
    npt = jnp.where(not_root, jnp.minimum(pt, INF), INF)
    trip_t = jnp.concatenate([ntime, npt, cev_t, cev_t], axis=1)  # [P, T]
    trip_s = jnp.concatenate(
        [
            jnp.ones((P, N)), -jnp.ones((P, N)),
            -jnp.ones((P, K)), jnp.ones((P, K)),
        ],
        axis=1,
    )
    trip_l = jnp.concatenate([pop, lab_end, cev_prev, cev_d], axis=1)

    def eval_rate(tq):
        """Coalescence rate (and its pieces) at query times tq [P, V]."""
        e_q = _epoch_index(start, tq)  # [P, V]
        oh_eq = e_q[..., None] == arangeE  # [P, V, E]
        start_q = jnp.sum(jnp.where(oh_eq, start[None, None, :], 0.0), axis=2)
        pm_q = jnp.sum(
            jnp.where(oh_eq[..., None], pm_i[None, None], 0), axis=2
        )  # [P, V, Pp]
        ne_row = jnp.sum(
            jnp.where(oh_eq[..., None], epochs.ne[None, None], 0.0), axis=2
        )  # [P, V, Pp]

        def path_pop(jt, jd, s0):
            napp = jnp.sum(jt[:, None, :] <= tq[:, :, None], axis=2)
            ohna = jnp.arange(Mj)[None, None, :] == (napp - 1)[:, :, None]
            last = jnp.sum(jnp.where(ohna, jd[:, None, :], 0), axis=2)
            raw = jnp.where(napp > 0, last, s0[:, None])  # [P, V]
            fold = jnp.sum(
                jnp.where(raw[..., None] == arangePp, pm_q, 0), axis=2
            )
            return raw, fold

        raw_f, f_pop = path_pop(jt_f, jd_f, p_raw0)
        _, r_pop = path_pop(jt_r, jd_r, pop_root)

        kb = jnp.sum(jnp.where(oh_eq[..., None], k_base[:, None], 0.0), axis=2)
        in_ep = (trip_t[:, None, :] > start_q[:, :, None]) & (
            trip_t[:, None, :] <= tq[:, :, None]
        )  # [P, V, T]
        oh_tl = trip_l[:, None, :, None] == arangePp[None, None, None, :]
        fold_tl = jnp.sum(
            jnp.where(oh_tl, pm_q[:, :, None, :], 0), axis=3
        )  # [P, V, T]
        contrib = jnp.where(in_ep, trip_s[:, None, :], 0.0)
        kdelta = jnp.sum(
            contrib[..., None]
            * (fold_tl[..., None] == arangePp).astype(jnp.float32),
            axis=2,
        )  # [P, V, Pp]
        kpop = kb + kdelta
        k_same = jnp.sum(
            jnp.where(f_pop[..., None] == arangePp, kpop, 0.0), axis=2
        )
        root_on = (tq >= root_h[:, None]) & (r_pop == f_pop)
        k_same = k_same + root_on.astype(jnp.float32)
        ne_f = jnp.sum(
            jnp.where(f_pop[..., None] == arangePp, ne_row, 0.0), axis=2
        )
        rate = k_same / (2.0 * jnp.maximum(ne_f, 1e-30))
        return rate, k_same, e_q, f_pop, r_pop

    # --- stage 3: hazard inversion over the breakpoint set ----------------
    v = jnp.concatenate(
        [
            h_r[:, None], time,
            jnp.broadcast_to(start[None, :], (P, E)),
            cev_t, jt_f, jt_r,
        ],
        axis=1,
    )  # [P, V]
    V = v.shape[1]
    rate_v, ks_v, e_v, fp_v, rp_v = eval_rate(v)
    vc = jnp.minimum(v, BIG)
    wnext = jnp.min(
        jnp.where(v[:, None, :] > v[:, :, None], vc[:, None, :], BIG), axis=2
    )  # [P, V] next distinct breakpoint
    dup = (
        jnp.sum(
            (v[:, None, :] == v[:, :, None])
            & (jnp.arange(V)[None, None, :] < jnp.arange(V)[None, :, None]),
            axis=2,
        )
        > 0
    )
    a = jnp.maximum(vc, h_r[:, None])
    valid = (~dup) & (v < 0.5 * INF)
    r_eff = jnp.where(valid, rate_v, 0.0)
    seg_v = jnp.clip(
        jnp.minimum(wnext[:, None, :], vc[:, :, None]) - a[:, None, :],
        0.0, None,
    )  # [P, V, V]
    lam_v = jnp.sum(seg_v * r_eff[:, None, :], axis=2)  # [P, V]

    u = jax.random.uniform(k_x, (P,), minval=1e-7, maxval=1.0 - 1e-7)
    x = -jnp.log1p(-u)
    ok_lo = (lam_v <= x[:, None]) & (v >= h_r[:, None]) & valid
    t_lo = jnp.max(jnp.where(ok_lo, vc, -INF), axis=1)  # h_r always qualifies
    hit_lo = ok_lo & (vc == t_lo[:, None])
    lam_lo = jnp.sum(jnp.where(hit_lo, lam_v, 0.0), axis=1)
    rate_lo = jnp.sum(jnp.where(hit_lo, rate_v, 0.0), axis=1)
    t_c = t_lo + jnp.where(
        rate_lo > 0, (x - lam_lo) / jnp.maximum(rate_lo, 1e-30), BIG
    )
    bad = t_c >= 0.5 * BIG
    maxnode = jnp.max(time, axis=1)
    t_c = jnp.where(bad, jnp.maximum(t_lo, maxnode), t_c)

    # --- coalescence target at t_c ---------------------------------------
    rate1, ks1, e1, fp1, rp1 = eval_rate(t_c[:, None])
    e_c, fpop_c, rp_c = e1[:, 0], fp1[:, 0], rp1[:, 0]
    appc = cev_t <= t_c[:, None]  # [P, K]
    m_cb = appc[:, None, :] & (cev_b[:, None, :] == arangeN[None, :, None])
    kc_i = jnp.argmax(jnp.where(m_cb, cev_t[:, None, :], -INF), axis=2)
    ohc = kc_i[..., None] == arangeK
    ld_c = jnp.sum(jnp.where(ohc, cev_d[:, None, :], 0), axis=2)
    lab_c = jnp.where(jnp.any(m_cb, axis=2), ld_c, pop)  # [P, N] raw
    oh_ec = e_c[:, None] == arangeE
    pm_c = jnp.sum(jnp.where(oh_ec[..., None], pm_i[None], 0), axis=1)
    fold_c = jnp.sum(
        jnp.where(lab_c[..., None] == arangePp, pm_c[:, None, :], 0), axis=2
    )
    fold_c = jnp.where(
        arangeN[None, :] == root[:, None], rp_c[:, None], fold_c
    )
    cross_c = (time <= t_c[:, None]) & (t_c[:, None] < pt)
    cand = cross_c & (fold_c == fpop_c[:, None])
    kc = jnp.sum(cand, axis=1)
    r = jnp.floor(
        jax.random.uniform(k_d, (P,)) * jnp.maximum(kc, 1)
    ).astype(jnp.int32)
    csum = jnp.cumsum(cand.astype(jnp.int32), axis=1) - 1
    d = jnp.argmax((csum == r[:, None]) & cand, axis=1).astype(jnp.int32)
    fail = bad | (kc == 0)
    d = jnp.where(fail, root, d)
    fpop_c = jnp.where(fail, rp_c, fpop_c)

    # --- records ----------------------------------------------------------
    len_j = jnp.where(
        valid,
        jnp.clip(jnp.minimum(wnext, t_c[:, None]) - a, 0.0, None),
        0.0,
    )  # [P, V]
    oh_ev = (e_v[..., None] == arangeE).astype(jnp.float32)  # [P, V, E]
    oh_fv = (fp_v[..., None] == arangePp).astype(jnp.float32)
    oh_rv = (rp_v[..., None] == arangePp).astype(jnp.float32)
    w_ep = oh_ev[..., :, None] * oh_fv[..., None, :]  # [P, V, E, Pp]
    coal_opp = jnp.sum((ks_v * len_j)[..., None, None] * w_ep, axis=1)
    mig_opp = jnp.sum(len_j[..., None, None] * w_ep, axis=1)
    above = (v >= root_h[:, None]).astype(jnp.float32)
    w_er = oh_ev[..., :, None] * oh_rv[..., None, :]
    mig_opp = mig_opp + jnp.sum(
        (above * len_j)[..., None, None] * w_er, axis=1
    )
    good = (~fail).astype(jnp.float32)
    coal_cnt = (
        (arangeE[None, :, None] == e_c[:, None, None])
        & (arangePp[None, None, :] == fpop_c[:, None, None])
    ).astype(jnp.float32) * good[:, None, None]

    def cnt_jumps(jt, jd, jfrom):
        use = ((jt < t_c[:, None]) & (jt < 0.5 * INF)).astype(jnp.float32)
        e_j = _epoch_index(start, jt)
        oh_e = (e_j[..., None] == arangeE).astype(jnp.float32)  # [P, Mj, E]
        oh_f = (jfrom[..., None] == arangePp).astype(jnp.float32)
        oh_d = (jd[..., None] == arangePp).astype(jnp.float32)
        return jnp.sum(
            use[..., None, None, None]
            * oh_e[:, :, :, None, None]
            * oh_f[:, :, None, :, None]
            * oh_d[:, :, None, None, :],
            axis=1,
        )  # [P, E, Pp, Pp]

    mig_cnt = cnt_jumps(jt_f, jd_f, jfrom_f) + cnt_jumps(jt_r, jd_r, jfrom_r)

    ev_keep = jt_f < t_c[:, None]
    ev_t = jnp.where(ev_keep, jt_f, INF)
    ev_d = jnp.where(ev_keep, jd_f, 0)
    rev_keep = jt_r < t_c[:, None]
    rev_t = jnp.where(rev_keep, jt_r, INF)
    rev_d = jnp.where(rev_keep, jd_r, 0)

    def saturated(jt):
        last = jnp.max(jnp.where(jt < 0.5 * INF, jt, -INF), axis=1)
        return (jnp.sum(jt < 0.5 * INF, axis=1) == Mj) & (t_c > last)

    over = (n_overflow > 0) & (
        t_c > jnp.max(jnp.where(cev_fin, cev_t, -INF), axis=1)
    )
    capped = (
        fail | saturated(jt_f) | saturated(jt_r) | over
    ).astype(jnp.float32)

    return (
        t_c, d, fpop_c, p_raw0,
        coal_opp, coal_cnt, mig_opp, mig_cnt,
        ev_t, ev_d, rev_t, rev_d, capped,
    )


# ---------------------------------------------------------------------------
# SPR update
# ---------------------------------------------------------------------------


def _replace_in_row(child_arr, node, old, new, N):
    """child_arr[node] == old -> new (one child array [N]), guarded for
    node < 0.  Masked select instead of a vmapped ``.at[idx].set``
    scatter."""
    hit = (jnp.arange(N) == node) & (child_arr == old)
    return jnp.where(hit & (node >= 0), new, child_arr)


def _set_at(arr, i, v):
    """arr with arr[i] = v, as a masked select (scatter-free under vmap)."""
    return jnp.where(jnp.arange(arr.shape[0]) == i, v, arr)


def _filter_events(ev_t, ev_d, lo, hi):
    """Keep events with lo <= t < hi; compact left; INF-pad.

    Inputs are time-sorted (every producer emits ascending INF-padded
    lists), so compaction is a stable cumsum-slot scatter — no sort (an
    argsort formulation needed ~15 vmapped [2Mw] sorts per transition)."""
    M = ev_t.shape[0]
    keep = (ev_t >= lo) & (ev_t < hi) & (ev_t < INF)
    slot = jnp.cumsum(keep.astype(jnp.int32)) - 1
    oh = (slot[:, None] == jnp.arange(M)[None, :]) & keep[:, None]
    t_out = jnp.sum(jnp.where(oh, ev_t[:, None], 0.0), axis=0)
    t_out = jnp.where(jnp.any(oh, axis=0), t_out, INF)
    d_out = jnp.sum(jnp.where(oh, ev_d[:, None], 0), axis=0)
    return t_out, d_out


def _merge_events_hold(t1, d1, t2, d2, M):
    """Merge two INF-padded time-sorted event lists into capacity ``M``.

    On overflow, drop the events with the smallest *hold time* (the interval
    until the next event on the branch): removing event i only changes the
    branch's population path over ``[t_i, t_{i+1})``, so min-hold dropping
    perturbs the path over the smallest possible windows.  The last event is
    never dropped (its hold is unbounded), keeping the pop seen by future
    coalescences above it exact.  (The reference stores migration events as
    unbounded scrm node chains; a fixed-capacity buffer needs a drop rule,
    and earliest-drop was measurably biased once buffers saturated.)

    Returns (times [M], dests [M], n_dropped scalar).

    Sort-free: both inputs are time-sorted, so the merge is a stable rank
    (pairwise comparisons, index tie-break) + one-hot scatter, and the
    min-hold drop rule a second rank on (-hold, index), with no vmapped
    argsort."""
    t = jnp.concatenate([t1, t2])
    d = jnp.concatenate([d1, d2])
    K = t.shape[0]
    iK = jnp.arange(K)
    first = (t[None, :] < t[:, None]) | (
        (t[None, :] == t[:, None]) & (iK[None, :] < iK[:, None])
    )
    rank = jnp.sum(first, axis=1)  # [K] stable rank by (time, index)
    oh = rank[:, None] == iK[None, :]
    ts = jnp.sum(jnp.where(oh, t[:, None], 0.0), axis=0)
    ds = jnp.sum(jnp.where(oh, d[:, None], 0), axis=0)
    valid = ts < INF
    nxt = jnp.append(ts[1:], INF)
    hold = jnp.where(valid, nxt - ts, -1.0)
    larger = (hold[None, :] > hold[:, None]) | (
        (hold[None, :] == hold[:, None]) & (iK[None, :] < iK[:, None])
    )
    keep = (jnp.sum(larger, axis=1) < M) & valid
    slot = jnp.cumsum(keep.astype(jnp.int32)) - 1
    ohk = (slot[:, None] == jnp.arange(M)[None, :]) & keep[:, None]
    tk = jnp.sum(jnp.where(ohk, ts[:, None], 0.0), axis=0)
    tk = jnp.where(jnp.any(ohk, axis=0), tk, INF)
    dk = jnp.sum(jnp.where(ohk, ds[:, None], 0), axis=0)
    n_dropped = jnp.maximum(jnp.sum(valid) - M, 0)
    return tk, dk, n_dropped


def _apply_spr(
    parent, time, pop, child0, child1, mig_time, mig_dest, c, d, t_c, fpop_c,
    new_ev_t, new_ev_d, h_r, root_ev_t=None, root_ev_d=None,
):
    """Constant-time SPR on the index arrays (+ migration-buffer routing).
    All node lookups are one-hot reductions, not batched gathers."""
    N = parent.shape[0]
    p = _oh_pick(parent, c)  # c is never the root (its branch has length 0)
    pc = jnp.clip(p, 0, N - 1)
    sib0 = _oh_pick(child0, pc)
    sib1 = _oh_pick(child1, pc)
    o = jnp.where(sib0 == c, sib1, sib0)
    g = _oh_pick(parent, jnp.clip(p, 0, N - 1))
    noop = d == c
    d_eff = jnp.where(d == p, o, d)
    gp = jnp.where(d_eff == o, g, _oh_pick(parent, jnp.clip(d_eff, 0, N - 1)))

    # splice o up to g
    new_parent = _set_at(parent, o, g)
    new_c0 = _replace_in_row(child0, g, p, o, N)
    new_c1 = _replace_in_row(child1, g, p, o, N)
    # insert node q (reusing slot p) on the branch above d_eff
    new_parent = _set_at(_set_at(new_parent, d_eff, p), p, gp)
    new_c0 = _set_at(new_c0, p, c)
    new_c1 = _set_at(new_c1, p, d_eff)
    new_c0 = _replace_in_row(new_c0, gp, d_eff, p, N)
    new_c1 = _replace_in_row(new_c1, gp, d_eff, p, N)
    new_time = _set_at(time, p, t_c)
    new_pop = _set_at(pop, p, fpop_c)

    n_drop = jnp.int32(0)
    if mig_time is not None:
        M = mig_time.shape[1]
        mig_c_t, mig_c_d = _oh_pick(mig_time, c), _oh_pick(mig_dest, c)
        # --- normal SPR event routing ---
        # c's branch [time[c], t_c): old events below the cut + walk events
        c_t0, c_d0 = _filter_events(mig_c_t, mig_c_d, -INF, h_r)
        c_t, c_d, dr1 = _merge_events_hold(c_t0, c_d0, new_ev_t, new_ev_d, M)
        # o's merged branch [time[o], time[g]): o events + p events
        o_t, o_d, dr2 = _merge_events_hold(
            _oh_pick(mig_time, o), _oh_pick(mig_dest, o),
            _oh_pick(mig_time, jnp.clip(p, 0, N - 1)),
            _oh_pick(mig_dest, jnp.clip(p, 0, N - 1)), M,
        )
        # d_eff's branch splits at t_c; its upper part becomes q(=p)'s branch.
        # When d_eff == o the split applies to the just-merged o branch.
        de_t = _oh_pick(mig_time, jnp.clip(d_eff, 0, N - 1))
        de_d = _oh_pick(mig_dest, jnp.clip(d_eff, 0, N - 1))
        do_t = jnp.where(d_eff == o, o_t, de_t)
        do_d = jnp.where(d_eff == o, o_d, de_d)
        dr3 = jnp.int32(0)
        if root_ev_t is not None:
            # coalescence with the ancestral lineage: the walk's realized
            # root-lineage migration path becomes the old root's branch events.
            # Note d == p == root remaps d_eff -> o, so test the ORIGINAL d too.
            root_old = jnp.argmax(parent < 0).astype(jnp.int32)
            is_root_tgt = (d == root_old) | (d_eff == root_old)
            add_t = jnp.where(is_root_tgt, root_ev_t, INF)
            add_d = jnp.where(is_root_tgt, root_ev_d, 0)
            do_t, do_d, dr3 = _merge_events_hold(do_t, do_d, add_t, add_d, M)
        dlow_t, dlow_d = _filter_events(do_t, do_d, -INF, t_c)
        dhigh_t, dhigh_d = _filter_events(do_t, do_d, t_c, INF)
        def set_row(a, i, v):
            return jnp.where((jnp.arange(N) == i)[:, None], v, a)

        nm, nd = mig_time, mig_dest
        nm = set_row(nm, o, o_t)
        nd = set_row(nd, o, o_d)
        nm = set_row(nm, d_eff, dlow_t)
        nd = set_row(nd, d_eff, dlow_d)
        nm = set_row(nm, c, c_t)
        nd = set_row(nd, c, c_d)
        nm = set_row(nm, p, dhigh_t)
        nd = set_row(nd, p, dhigh_d)
        # --- self-coalescence: replace c's [h_r, t_c) section with the walk's
        # events, keep old events outside the window ---
        cs_lo_t, cs_lo_d = _filter_events(mig_c_t, mig_c_d, -INF, h_r)
        cs_hi_t, cs_hi_d = _filter_events(mig_c_t, mig_c_d, t_c, INF)
        cs_t, cs_d, dr4 = _merge_events_hold(
            cs_lo_t, cs_lo_d, new_ev_t, new_ev_d, M
        )
        cs_t, cs_d, dr5 = _merge_events_hold(cs_t, cs_d, cs_hi_t, cs_hi_d, M)
        noop_nm = set_row(mig_time, c, cs_t)
        noop_nd = set_row(mig_dest, c, cs_d)
        mig_time_f = jnp.where(noop, noop_nm, nm)
        mig_dest_f = jnp.where(noop, noop_nd, nd)
        n_drop = jnp.where(noop, dr4 + dr5, dr1 + dr2 + dr3)
        noop_pop = pop
    else:
        mig_time_f = None
        mig_dest_f = None
        noop_pop = pop

    parent_f = jnp.where(noop, parent, new_parent)
    time_f = jnp.where(noop, time, new_time)
    pop_f = jnp.where(noop, noop_pop, new_pop)
    child0_f = jnp.where(noop, child0, new_c0)
    child1_f = jnp.where(noop, child1, new_c1)
    if mig_time is not None:
        # prune the root's ancestral-lineage events: the path above the root
        # is re-simulated fresh by every walk (memoryless), so storing it
        # would only accumulate stale history unboundedly
        root_f = jnp.argmax(parent_f < 0).astype(jnp.int32)
        root_row = (jnp.arange(N) == root_f)[:, None]
        mig_time_f = jnp.where(root_row, INF, mig_time_f)
        mig_dest_f = jnp.where(root_row, 0, mig_dest_f)
    return (parent_f, time_f, pop_f, child0_f, child1_f, mig_time_f,
            mig_dest_f, n_drop)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def recombination_transition(
    keys: jnp.ndarray,
    trees: Trees,
    epochs: Epochs,
    active: jnp.ndarray,
    has_migration: bool = False,
    max_events: int = 256,
    bias_heights=None,
    bias_strengths=None,
    leaf_rates=None,
    mig_uniform: bool = False,
    mig_jumps: int = 0,
    mig_compact: int = 0,
):
    """Apply one masked SMC' transition to every active particle.

    ``active`` [P] bool — particles whose next recombination position falls
    inside the current update window; inactive particles pass through
    untouched and record zeros.  ``leaf_rates`` [P, n] (optional) are
    per-particle relative guide rates at each leaf (pfparam.hpp:96-223).

    Staging: point sampling and the SPR are embarrassingly parallel and run
    under vmap; the migration event walk (the only data-dependent loop) runs
    as ONE population-batched while_loop (_walk_mig_batched).
    """
    has_mig_arrays = trees.mig_time is not None
    E = epochs.num_epochs
    parent, time, pop = trees.parent, trees.time, trees.pop
    child0, child1 = trees.child0, trees.child1

    split = jax.vmap(lambda k: jax.random.split(k))(keys)  # [P, 2, 2]
    k_rec, k_walk = split[:, 0], split[:, 1]

    # --- 1. sample the recombination point ------------------------------
    if bias_strengths is not None or leaf_rates is not None:
        if bias_strengths is None:
            # guide without height bias: one all-heights section, strength 1
            bias_heights = jnp.asarray([0.0, INF], jnp.float32)
            bias_strengths = jnp.asarray([1.0], jnp.float32)

        def point_one(k, t, p, ch0, ch1, lrates):
            br = (
                guide_branch_rates(t, p, ch0, ch1, lrates)
                if lrates is not None
                else None
            )
            return _sample_recomb_point_biased(
                k, t, p, bias_heights, bias_strengths, br
            )

        lr_ax = None if leaf_rates is None else 0
        c, h_r, log_iw, strength, log_iw_bias = jax.vmap(
            point_one, in_axes=(0, 0, 0, 0, 0, lr_ax)
        )(k_rec, time, parent, child0, child1, leaf_rates)
    else:
        c, h_r = jax.vmap(_sample_recomb_point)(k_rec, time, parent)
        log_iw = jnp.zeros((c.shape[0],))
        log_iw_bias = jnp.zeros((c.shape[0],))
        strength = jnp.ones((c.shape[0],))

    # --- 2. re-coalescence walk -----------------------------------------
    P = c.shape[0]
    if has_migration:
        walk = (
            _walk_mig_batched
            if os.environ.get("SMCSMC_MIG_WALK", "jump") == "loop"
            else _walk_mig_jump
        )
        kw = {} if walk is _walk_mig_batched else {
            "mig_uniform": mig_uniform,
            "mig_jumps": mig_jumps,
            "mig_compact": mig_compact,
        }
        (t_c, d, fpop_c, start_pop, coal_opp, coal_cnt, mig_opp, mig_cnt,
         ev_t, ev_d, rev_t, rev_d, walk_capped) = walk(
            k_walk[0], time, parent, pop, trees.mig_time, trees.mig_dest,
            c, h_r, epochs, max_events, active, **kw,
        )
        # per-event source-pop path for the ARG's M rows: the new branch's
        # lineage starts in start_pop and hops dest-to-dest
        mig_ev_from = jnp.concatenate(
            [start_pop[:, None], ev_d[:, :-1]], axis=1
        )
    else:
        (t_c, d, fpop_c, coal_opp, coal_cnt, mig_opp, mig_cnt, _, _) = (
            jax.vmap(
                lambda k, t, p, po, cc, hh: _walk_fast(
                    k, t, p, po, cc, hh, epochs
                )
            )(k_walk, time, parent, pop, c, h_r)
        )
        rev_t = rev_d = None
        ev_t = ev_d = None
        mig_ev_from = None
        walk_capped = jnp.zeros((P,))
        if has_mig_arrays:
            _, _, Mw = trees.mig_time.shape
            ev_t = jnp.full((P, Mw), INF)
            ev_d = jnp.zeros((P, Mw), jnp.int32)

    # --- 3. the SPR topology update --------------------------------------
    if has_mig_arrays:
        spr_in = (parent, time, pop, child0, child1, trees.mig_time,
                  trees.mig_dest, c, d, t_c, fpop_c, ev_t, ev_d, h_r)
        if rev_t is not None:
            pf, tf, popf, c0f, c1f, mtf, mdf, n_drop = jax.vmap(_apply_spr)(
                *spr_in, rev_t, rev_d
            )
        else:
            pf, tf, popf, c0f, c1f, mtf, mdf, n_drop = jax.vmap(
                lambda *a: _apply_spr(*a, None, None)
            )(*spr_in)
    else:
        pf, tf, popf, c0f, c1f, mtf, mdf, n_drop = jax.vmap(
            lambda p, t, po, ch0, ch1, cc, dd, tc, fp, hh: _apply_spr(
                p, t, po, ch0, ch1, None, None, cc, dd, tc, fp, None, None,
                hh,
            )
        )(parent, time, pop, child0, child1, c, d, t_c, fpop_c, h_r)

    # --- 4. masking + the statistic record --------------------------------
    act = active
    pf = jnp.where(act[:, None], pf, parent)
    tf = jnp.where(act[:, None], tf, time)
    popf = jnp.where(act[:, None], popf, pop)
    c0f = jnp.where(act[:, None], c0f, child0)
    c1f = jnp.where(act[:, None], c1f, child1)
    if mtf is not None:
        mtf = jnp.where(act[:, None, None], mtf, trees.mig_time)
        mdf = jnp.where(act[:, None, None], mdf, trees.mig_dest)

    e_r = _epoch_index(epochs.start, h_r)  # [P]
    recomb_cnt = (e_r[:, None] == jnp.arange(E)[None, :]).astype(jnp.float32)
    rec = TransitionRecord(
        coal_opp=coal_opp,
        coal_cnt=coal_cnt,
        mig_opp=mig_opp,
        mig_cnt=mig_cnt,
        recomb_cnt=recomb_cnt,
        recomb_height=h_r,
        coal_height=t_c,
        log_iw=log_iw,
        log_iw_bias=log_iw_bias,
        point_strength=strength,
        c_node=c,
        d_node=d,
        coal_pop=fpop_c,
        walk_capped=walk_capped,
        buf_dropped=n_drop.astype(jnp.float32),
        mig_ev_t=ev_t if has_migration else None,
        mig_ev_from=mig_ev_from,
        mig_ev_to=ev_d if has_migration else None,
    )
    rec = jax.tree_util.tree_map(
        lambda x: jnp.where(
            act.reshape((-1,) + (1,) * (x.ndim - 1)), x, jnp.zeros_like(x)
        ),
        rec,
    )
    return (
        Trees(
            parent=pf, time=tf, pop=popf, child0=c0f, child1=c1f,
            mig_time=mtf, mig_dest=mdf,
        ),
        rec,
    )
