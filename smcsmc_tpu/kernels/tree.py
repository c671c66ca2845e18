"""Array-encoded genealogies and batched coalescent primitives.

The reference represents each particle as a linked scrm ``Forest``
(/root/reference/src/particle.hpp:118, scrm ``node.h``/``forest.cc``); here a
particle population is a structure-of-arrays pytree with fixed shapes so the
entire population advances in lock-step under ``jit``/``vmap``/``shard_map``.

Node layout for ``n`` sampled haplotypes: nodes ``0..n-1`` are leaves,
``n..2n-2`` are internal; the root is the node with ``parent == -1``.  The
"branch above" node ``i`` spans ``[time[i], time[parent[i]])``; the root's
branch above is its (infinite) ancestral lineage, which is how the SMC'
transition kernel exposes re-coalescence above the root.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

NO_NODE = jnp.int32(-1)
INF = jnp.float32(3e38)


class Trees(NamedTuple):
    """Batched genealogy state. Leading axis = particles.

    parent   : [P, N] i32 — parent index, -1 at root
    time     : [P, N] f32 — node height (generations)
    pop      : [P, N] i32 — population of the lineage at the node's own time
    child0   : [P, N] i32 — first-child index, -1 for leaves
    child1   : [P, N] i32 — second-child index, -1 for leaves
               (two flat arrays, NOT one [P, N, 2] tensor: a trailing dim of
               2 forces XLA into T(2,128) tilings that disagree across the
               while/cond program regions, costing a 100 µs layout-change
               copy per segment in the sweep)
    mig_time : [P, N, M] f32 — migration-event times on the branch above each
               node, ascending, INF-padded (None for migration-free models)
    mig_dest : [P, N, M] i32 — destination population of each event
               (backwards in time; scrm stores these as unary Nodes with
               ``is_migrating()``, SURVEY.md §2.3)
    """

    parent: jnp.ndarray
    time: jnp.ndarray
    pop: jnp.ndarray
    child0: jnp.ndarray
    child1: jnp.ndarray
    mig_time: jnp.ndarray = None
    mig_dest: jnp.ndarray = None

    @property
    def children(self) -> jnp.ndarray:
        """[..., N, 2] stacked view (compatibility accessor; cold paths)."""
        return jnp.stack([self.child0, self.child1], axis=-1)

    @property
    def num_nodes(self) -> int:
        return self.parent.shape[-1]

    @property
    def num_leaves(self) -> int:
        return (self.num_nodes + 1) // 2


def branch_pop_at(
    tree_pop: jnp.ndarray,
    mig_time: jnp.ndarray,
    mig_dest: jnp.ndarray,
    pop_map_e: jnp.ndarray,
    t: jnp.ndarray,
) -> jnp.ndarray:
    """[N] population of each branch (the lineage above each node) at time t,
    accounting for that branch's migration events below t and the epoch's
    -ej relabeling."""
    if mig_time is None:
        return pop_map_e[tree_pop]
    k = jnp.sum(mig_time <= t, axis=-1)  # [N] events applied
    last = jnp.where(
        k > 0,
        jnp.take_along_axis(
            mig_dest, jnp.maximum(k - 1, 0)[:, None], axis=-1
        )[:, 0],
        tree_pop,
    )
    return pop_map_e[last]


class Epochs(NamedTuple):
    """Device-side demography (piecewise constant; times in generations).

    start : [E] f32 — epoch start times, start[0] == 0
    ne    : [E, Pp] f32 — diploid population sizes
    mig   : [E, Pp, Pp] f32 — per-generation backwards migration rates
    pop_map : [E, Pp] i32 — population relabeling per epoch (folds -ej splits)
    """

    start: jnp.ndarray
    ne: jnp.ndarray
    mig: jnp.ndarray
    pop_map: jnp.ndarray

    @property
    def num_epochs(self) -> int:
        return self.start.shape[0]

    @property
    def num_pops(self) -> int:
        return self.ne.shape[1]

    @property
    def end(self) -> jnp.ndarray:
        return jnp.append(self.start[1:], INF)


def epochs_from_demography(demo) -> Epochs:
    """Build device Epochs from a host :class:`~smcsmc_tpu.demography.Demography`."""
    return Epochs(
        start=jnp.asarray(demo.change_times, dtype=jnp.float32),
        ne=jnp.asarray(demo.pop_sizes, dtype=jnp.float32),
        mig=jnp.asarray(demo.mig_rates, dtype=jnp.float32),
        pop_map=jnp.asarray(demo.pop_map_at_epoch(), dtype=jnp.int32),
    )


# ---------------------------------------------------------------------------
# per-particle helpers (written for a single particle; vmap over particles)
# ---------------------------------------------------------------------------


def parent_time(tree_time: jnp.ndarray, tree_parent: jnp.ndarray) -> jnp.ndarray:
    """[N] time of each node's parent; INF for the root (its branch above is
    the unbounded ancestral lineage).  One-hot reduction instead of a
    batched gather; this sits in every hot kernel."""
    N = tree_time.shape[0]
    pt = jnp.sum(
        jnp.where(
            tree_parent[:, None] == jnp.arange(N)[None, :],
            tree_time[None, :], 0.0,
        ),
        axis=1,
    )
    return jnp.where(tree_parent < 0, INF, pt)


def branch_lengths(tree_time: jnp.ndarray, tree_parent: jnp.ndarray) -> jnp.ndarray:
    """[N] finite branch lengths (0 for the root's infinite lineage)."""
    pt = parent_time(tree_time, tree_parent)
    return jnp.where(tree_parent < 0, 0.0, pt - tree_time)


def total_branch_length(tree_time: jnp.ndarray, tree_parent: jnp.ndarray) -> jnp.ndarray:
    """Scalar local tree length (scrm ``getLocalTreeLength``)."""
    return jnp.sum(branch_lengths(tree_time, tree_parent))


def lineage_count_at(
    tree_time: jnp.ndarray, tree_parent: jnp.ndarray, t: jnp.ndarray
) -> jnp.ndarray:
    """Number of lineages (branches, incl. the root's ancestral lineage)
    crossing each time in ``t``: k(s) = #{i : time[i] <= s < parent_time[i]}.

    Uses two sorted searches instead of an [|t|, N] comparison so the batched
    version stays O(P·|t|·log N) in time and O(P·(|t|+N)) in memory.
    """
    starts = jnp.sort(tree_time)
    pt = parent_time(tree_time, tree_parent)
    ends = jnp.sort(jnp.where(jnp.isinf(pt) | (pt >= INF), INF, pt))
    n_started = jnp.searchsorted(starts, t, side="right")
    n_ended = jnp.searchsorted(ends, t, side="right")
    return (n_started - n_ended).astype(jnp.int32)


def branch_length_per_epoch(
    tree_time: jnp.ndarray,
    tree_parent: jnp.ndarray,
    epoch_start: jnp.ndarray,
    epoch_end: jnp.ndarray,
) -> jnp.ndarray:
    """[E] total (finite) branch length inside each epoch.

    Feeds the recombination-opportunity record (reference: coalevent.hpp:221
    ``recomb_opportunity = weight * dt * dx`` summed over time slices — the
    sum over slices of contemporaries×slice-length is exactly the local tree
    length restricted to the epoch)."""
    pt = parent_time(tree_time, tree_parent)
    lo = jnp.maximum(tree_time[None, :], epoch_start[:, None])  # [E, N]
    hi = jnp.minimum(pt[None, :], epoch_end[:, None])
    overlap = jnp.clip(hi - lo, 0.0, None)
    overlap = jnp.where(tree_parent[None, :] < 0, 0.0, overlap)
    return jnp.sum(overlap, axis=1)


def leaf_ancestor_ids(tree_parent: jnp.ndarray) -> jnp.ndarray:
    """[n, n] node ids: column 0 is each leaf itself, column k its k-th
    ancestor (-1 past the root).  A leaf has at most n-1 ancestors, so n
    columns cover every root path — replaces height-ordered sequential
    traversals.  Small n unrolls the n-1 gathers; large n uses a scan so the
    traced program stays O(1) in n (the reference's 64-leaf Descendants_t
    contract, descendants.hpp:16, would otherwise wall out compile time)."""
    N = tree_parent.shape[0]
    n = (N + 1) // 2

    def up(cur):
        # parent lookup as a one-hot reduction (gather-free)
        par = jnp.sum(
            jnp.where(
                cur[:, None] == jnp.arange(N)[None, :],
                tree_parent[None, :], 0,
            ),
            axis=1,
        )
        return jnp.where(cur >= 0, par, -1)

    first = jnp.arange(n, dtype=jnp.int32)
    if n <= 8:
        cols = [first]
        cur = first
        for _ in range(n - 1):
            cur = up(cur)
            cols.append(cur)
        return jnp.stack(cols, axis=1)

    def step(cur, _):
        nxt = up(cur)
        return nxt, nxt

    _, rest = jax.lax.scan(step, first, None, length=n - 1)  # [n-1, n]
    return jnp.concatenate([first[None, :], rest], axis=0).T


def count_data_leaves_below(
    tree_children,  # unused (kept for call-site compatibility)
    tree_time: jnp.ndarray,
    has_data: jnp.ndarray,
    tree_parent: jnp.ndarray = None,
) -> jnp.ndarray:
    """[N] number of data-carrying leaves below (and including) each node.

    Adds each leaf's data flag onto its ancestor chain (reference recursion:
    particle.cpp:706-730) via a one-hot masked sum instead of a vmapped
    scatter.  ``tree_parent`` is required (kept last for call-site
    compatibility)."""
    N = tree_time.shape[0]
    ids = leaf_ancestor_ids(tree_parent).reshape(-1)  # [n*n]
    vals = jnp.broadcast_to(
        has_data.astype(jnp.int32)[:, None],
        (has_data.shape[0], has_data.shape[0]),
    ).reshape(-1)
    hit = ids[None, :] == jnp.arange(N)[:, None]  # [N, n*n]
    return jnp.sum(jnp.where(hit, vals[None, :], 0), axis=1)


def data_branch_length(
    tree_time: jnp.ndarray,
    tree_parent: jnp.ndarray,
    tree_children: jnp.ndarray,
    has_data: jnp.ndarray,
) -> jnp.ndarray:
    """Total length of branches informative about mutations: branches with at
    least one data-carrying descendant, below the MRCA of the data leaves
    (reference: particle.cpp:699-730, ``trackLocalTreeBranchLength``)."""
    cnt = count_data_leaves_below(tree_children, tree_time, has_data, tree_parent)
    total = jnp.sum(has_data.astype(jnp.int32))
    bl = branch_lengths(tree_time, tree_parent)
    informative = (cnt >= 1) & (cnt < total)
    return jnp.sum(jnp.where(informative, bl, 0.0))


def descendant_bitmask(
    tree_children,  # unused (kept for call-site compatibility)
    tree_time: jnp.ndarray,
    tree_parent: jnp.ndarray = None,
) -> jnp.ndarray:
    """[N] u32 bitmask of sample leaves below each node, for <=32 leaves;
    :func:`descendant_bitmask64` covers the reference's full 64-leaf
    contract (descendants.hpp:16).

    One-hot masked sum: each leaf ORs its bit onto its ancestor chain (bits
    are disjoint across leaves, so add == or); scatter-free under vmap."""
    N = tree_time.shape[0]
    n = (N + 1) // 2
    ids = leaf_ancestor_ids(tree_parent).reshape(-1)  # [n*n]
    bits = jnp.broadcast_to(
        (jnp.uint32(1) << jnp.arange(n, dtype=jnp.uint32))[:, None], (n, n)
    ).reshape(-1)
    hit = ids[None, :] == jnp.arange(N)[:, None]  # [N, n*n]
    return jnp.sum(jnp.where(hit, bits[None, :], jnp.uint32(0)), axis=1)


def descendant_bitmask64(
    tree_children,  # unused (kept for call-site compatibility)
    tree_time: jnp.ndarray,
    tree_parent: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[N] (lo, hi) u32 pair covering up to 64 sample leaves — full parity
    with the reference's u64 Descendants_t (descendants.hpp:16-33) without
    requiring JAX's x64 mode."""
    N = tree_time.shape[0]
    n = (N + 1) // 2
    ids = leaf_ancestor_ids(tree_parent).reshape(-1)  # [n*n]
    leaf = jnp.arange(n, dtype=jnp.uint32)
    bit_lo = jnp.where(leaf < 32, jnp.uint32(1) << (leaf % 32), jnp.uint32(0))
    bit_hi = jnp.where(leaf >= 32, jnp.uint32(1) << (leaf % 32), jnp.uint32(0))
    blo = jnp.broadcast_to(bit_lo[:, None], (n, n)).reshape(-1)
    bhi = jnp.broadcast_to(bit_hi[:, None], (n, n)).reshape(-1)
    hit = ids[None, :] == jnp.arange(N)[:, None]  # [N, n*n]
    lo = jnp.sum(jnp.where(hit, blo[None, :], jnp.uint32(0)), axis=1)
    hi = jnp.sum(jnp.where(hit, bhi[None, :], jnp.uint32(0)), axis=1)
    return lo, hi


# ---------------------------------------------------------------------------
# piecewise-exponential sampling
# ---------------------------------------------------------------------------


def sample_piecewise_exponential(
    u: jnp.ndarray,
    t0: jnp.ndarray,
    seg_start: jnp.ndarray,
    seg_end: jnp.ndarray,
    seg_rate: jnp.ndarray,
) -> jnp.ndarray:
    """Invert a unit-exponential draw through a piecewise-constant hazard.

    ``u`` in (0,1); pieces ``[seg_start_j, seg_end_j)`` with rates
    ``seg_rate_j`` must tile ``[t0, inf)`` (pieces before ``t0`` are clipped
    away).  Returns the event time (INF if total hazard is finite and the
    draw survives it).  This replaces scrm's per-event
    ``sampleExpoLimit``/``TimeInterval`` walk with one vectorized inversion.
    """
    x = -jnp.log1p(-u)  # Exp(1)
    lo = jnp.maximum(seg_start, t0)
    ln = jnp.clip(seg_end - lo, 0.0, None)
    haz = jnp.where(ln > 0, seg_rate * ln, 0.0)
    # piece with infinite length and positive rate has infinite hazard
    haz = jnp.where((ln >= INF) & (seg_rate > 0), INF, haz)
    cum = jnp.cumsum(haz)
    idx = jnp.searchsorted(cum, x, side="left")
    idx = jnp.clip(idx, 0, seg_rate.shape[0] - 1)
    prev = jnp.where(idx > 0, cum[jnp.maximum(idx - 1, 0)], 0.0)
    rate = seg_rate[idx]
    t = lo[idx] + jnp.where(rate > 0, (x - prev) / jnp.maximum(rate, 1e-30), INF)
    return jnp.where(x > cum[-1], INF, t)


# ---------------------------------------------------------------------------
# initial tree sampling (reference: scrm buildInitialTree, used at
# particleContainer.cpp:33-65)
# ---------------------------------------------------------------------------


def make_initial_trees(
    key: jnp.ndarray,
    epochs: Epochs,
    num_particles: int,
    sample_pop: jnp.ndarray,
    sample_time: jnp.ndarray | None = None,
    max_mig: int = 16,
    max_iters: int = 256,
) -> Trees:
    """Draw the initial particle population of genealogies at sequence
    position 0 (reference: particleContainer.cpp:33-65) by an event-driven
    structured-coalescent walk over {epoch boundary, sample activation,
    migration, coalescence}, with per-branch migration-event recording.

    Population-batched by construction: ONE ``lax.while_loop`` advances all
    particles in lock-step with explicit per-particle done-masking, instead
    of vmapping a scalar while loop: lock-step masking is the idiomatic
    SPMD formulation, and a vmapped while loop was once miscompiled at
    batches >= 1024 by an accelerator runtime this code ran on.

    ``max_mig=0`` omits the per-branch migration-event buffers entirely
    (migration-free models: no buffer sorts anywhere downstream)."""
    n = int(sample_pop.shape[0])
    if sample_time is None:
        sample_time = jnp.zeros((n,), dtype=jnp.float32)
    sample_time = jnp.asarray(sample_time, jnp.float32)
    sample_pop = jnp.asarray(sample_pop, jnp.int32)
    P = num_particles
    N = 2 * n - 1
    E, Pp = epochs.num_epochs, epochs.num_pops
    rowid = jnp.arange(P)

    state = dict(
        key=key,
        parent=jnp.full((P, N), NO_NODE, dtype=jnp.int32),
        time=jnp.broadcast_to(
            jnp.concatenate([sample_time, jnp.zeros(n - 1)]), (P, N)
        ),
        pop=jnp.broadcast_to(
            jnp.concatenate([sample_pop, jnp.zeros(n - 1, jnp.int32)]), (P, N)
        ),
        child0=jnp.full((P, N), NO_NODE, dtype=jnp.int32),
        child1=jnp.full((P, N), NO_NODE, dtype=jnp.int32),
        # slot arrays over leaves+merges: node id / alive / current raw pop
        node_id=jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (P, n)),
        alive=jnp.broadcast_to(sample_time <= 0.0, (P, n)),
        cur_pop=jnp.broadcast_to(sample_pop, (P, n)),
        t=jnp.zeros((P,)),
        next_id=jnp.full((P,), n, jnp.int32),
        it=jnp.int32(0),
    )
    if max_mig:
        state["mig_time"] = jnp.full((P, N, max_mig), INF, dtype=jnp.float32)
        state["mig_dest"] = jnp.zeros((P, N, max_mig), dtype=jnp.int32)

    def live(s):
        # particle still has >1 active-or-pending lineages
        return (
            jnp.sum(s["alive"], axis=1)
            + jnp.sum(sample_time[None, :] > s["t"][:, None], axis=1)
        ) > 1

    def cond(s):
        return jnp.any(live(s)) & (s["it"] < max_iters)

    def body(s):
        key, k1, k2, k3, k4, k5 = jax.random.split(s["key"], 6)
        go = live(s)  # [P]
        t = s["t"]
        e = jnp.clip(
            jnp.searchsorted(epochs.start, t, side="right") - 1, 0, E - 1
        )  # [P]
        pm = epochs.pop_map[e]  # [P, Pp]
        mapped = jnp.where(
            s["alive"],
            jnp.take_along_axis(pm, s["cur_pop"], axis=1),
            -1,
        )  # [P, n]
        counts = jnp.sum(
            mapped[:, None, :] == jnp.arange(Pp)[None, :, None], axis=2
        ).astype(jnp.float32)  # [P, Pp]
        ne_e = epochs.ne[e]  # [P, Pp]
        coal_rates = counts * (counts - 1) / 2.0 / (2.0 * ne_e)  # [P, Pp]
        mig_out = jnp.sum(epochs.mig[e], axis=2)  # [P, Pp] total out-rate
        lin_mig = jnp.where(
            s["alive"], jnp.take_along_axis(mig_out, mapped * (mapped >= 0), axis=1), 0.0
        )  # [P, n]
        total = jnp.sum(coal_rates, axis=1) + jnp.sum(lin_mig, axis=1)  # [P]
        # next breakpoint: epoch end or next sample activation
        e_end = jnp.where(e + 1 < E, epochs.start[jnp.minimum(e + 1, E - 1)], INF)
        future = jnp.where(
            sample_time[None, :] > t[:, None], sample_time[None, :], INF
        )
        t_bk = jnp.minimum(e_end, jnp.min(future, axis=1))  # [P]
        u = jax.random.uniform(k1, (P,), minval=1e-7, maxval=1.0 - 1e-7)
        dt = jnp.where(total > 0, -jnp.log1p(-u) / jnp.maximum(total, 1e-30), INF)
        hit_bk = t + dt >= t_bk
        t_new = jnp.where(hit_bk, t_bk, t + dt)

        # --- event choice: coalescence-in-pop vs per-lineage migration ----
        weights = jnp.concatenate([coal_rates, lin_mig], axis=1)  # [P, Pp+n]
        idx = jax.random.categorical(
            k2, jnp.log(jnp.maximum(weights, 1e-30)), axis=-1
        )  # [P]
        is_coal = idx < Pp

        # --- coalescence lane --------------------------------------------
        cpop = jnp.clip(idx, 0, Pp - 1)  # [P] population of the merge
        in_pop = (mapped == cpop[:, None]) & s["alive"]  # [P, n]
        m = jnp.sum(in_pop, axis=1)  # [P]
        u1 = jax.random.uniform(k3, (P,))
        u2 = jax.random.uniform(k4, (P,))
        r1 = jnp.floor(u1 * jnp.maximum(m, 1)).astype(jnp.int32)
        r2 = jnp.floor(u2 * jnp.maximum(m - 1, 1)).astype(jnp.int32)
        r2 = jnp.where(r2 >= r1, r2 + 1, r2)
        csum = jnp.cumsum(in_pop.astype(jnp.int32), axis=1) - 1  # [P, n]
        slot1 = jnp.argmax((csum == r1[:, None]) & in_pop, axis=1)  # [P]
        slot2 = jnp.argmax((csum == r2[:, None]) & in_pop, axis=1)
        a = s["node_id"][rowid, slot1]
        b = s["node_id"][rowid, slot2]
        m_id = s["next_id"]
        do_coal = go & ~hit_bk & is_coal & (m >= 2)

        def setm(arr, i1, val, mask):
            # masked select over the column axis (scatter-free)
            K = arr.shape[1]
            hit = (jnp.arange(K)[None, :] == i1[:, None]) & mask[:, None]
            return jnp.where(hit, val[:, None], arr)

        parent = setm(s["parent"], a, m_id, do_coal)
        parent = setm(parent, b, m_id, do_coal)
        hit_m = (jnp.arange(N)[None, :] == m_id[:, None]) & do_coal[:, None]
        child0 = jnp.where(hit_m, a[:, None], s["child0"])
        child1 = jnp.where(hit_m, b[:, None], s["child1"])
        time = setm(s["time"], m_id, t_new, do_coal)
        pop = setm(s["pop"], m_id, cpop, do_coal)
        node_id = setm(s["node_id"], slot1, m_id, do_coal)
        alive = setm(s["alive"], slot2, jnp.zeros((P,), bool), do_coal)
        cur_pop = setm(s["cur_pop"], slot1, cpop, do_coal)
        next_id = jnp.where(do_coal, m_id + 1, m_id)

        # --- migration lane ----------------------------------------------
        do_mig = go & ~hit_bk & ~is_coal
        slot = jnp.clip(idx - Pp, 0, n - 1)  # [P]
        src = jnp.take_along_axis(pm, cur_pop[rowid, slot][:, None], axis=1)[
            :, 0
        ]
        w = epochs.mig[e, src]  # [P, Pp]
        dest = jax.random.categorical(
            k5, jnp.log(jnp.maximum(w, 1e-30)), axis=-1
        ).astype(jnp.int32)
        cur_pop = setm(cur_pop, slot, dest, do_mig)

        out = dict(
            key=key,
            parent=parent,
            time=time,
            pop=pop,
            child0=child0,
            child1=child1,
            node_id=node_id,
            alive=alive,
            cur_pop=cur_pop,
            t=jnp.where(go, t_new, t),
            next_id=next_id,
            it=s["it"] + 1,
        )
        if max_mig:
            node = s["node_id"][rowid, slot]  # [P]
            row_ev = s["mig_time"][rowid, node]  # [P, max_mig]
            cnt = jnp.minimum(jnp.sum(row_ev < INF, axis=1), max_mig - 1)
            hit3 = (
                (jnp.arange(N)[None, :, None] == node[:, None, None])
                & (jnp.arange(max_mig)[None, None, :] == cnt[:, None, None])
                & do_mig[:, None, None]
            )  # [P, N, max_mig]
            out["mig_time"] = jnp.where(
                hit3, t_new[:, None, None], s["mig_time"]
            )
            out["mig_dest"] = jnp.where(
                hit3, dest[:, None, None], s["mig_dest"]
            )

        # --- sample activation at breakpoints ----------------------------
        act = (
            go[:, None]
            & hit_bk[:, None]
            & jnp.isclose(sample_time[None, :], t_bk[:, None])
        )
        out["alive"] = out["alive"] | act
        return out

    s = jax.lax.while_loop(cond, body, state)
    return Trees(
        parent=s["parent"],
        time=s["time"],
        pop=s["pop"],
        child0=s["child0"],
        child1=s["child1"],
        mig_time=s.get("mig_time"),
        mig_dest=s.get("mig_dest"),
    )
