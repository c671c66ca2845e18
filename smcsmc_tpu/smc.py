"""The particle-filter sweep along the genome.

Array-parallel replacement for the reference's sweep loop
(/root/reference/src/smcsmc.cpp:324-360 ``pfARG_core``;
particleContainer.cpp:441-466 ``update_state_to_data``;
particle.cpp:743-918 ``extend_ARG``):

- the segment loop is a ``lax.scan`` over fixed-size blocks of .seg records;
- each particle's per-segment recombination events run in a masked
  ``lax.while_loop`` over the whole population at once;
- weight normalization / ESS / the log-likelihood are population reductions;
- systematic resampling (particleContainer.cpp:474-504) is a device-side
  cumsum + searchsorted + gather over the particle axis;
- lagged sufficient statistics (count.cpp:355-415) live in a per-particle
  FIFO ring over genome spans, committed with the particle's *current*
  normalized weight once the sweep front has passed ``position + lag[epoch]``
  — reproducing the reference's "count once, with the summed posterior weight
  of all descendants, only after the front has passed x+lag" semantics
  (the FIFO rides through resampling via the ancestry gather).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .kernels.likelihood import site_log_likelihood
from .kernels.transition import _epoch_index, recombination_transition
from .kernels.tree import (
    INF,
    Epochs,
    Trees,
    branch_length_per_epoch,
    data_branch_length,
    make_initial_trees,
)

# ---------------------------------------------------------------------------
# sufficient statistics
# ---------------------------------------------------------------------------


class SuffStats(NamedTuple):
    """Opportunity/count tensors (reference: count.hpp:92-100). Leading axes
    vary: [] global, [P] per-particle increments, [P, F] the lag FIFO."""

    coal_opp: jnp.ndarray  # [..., E, Pp]
    coal_cnt: jnp.ndarray  # [..., E, Pp]
    mig_opp: jnp.ndarray  # [..., E, Pp]
    mig_cnt: jnp.ndarray  # [..., E, Pp, Pp]
    recomb_opp: jnp.ndarray  # [..., E]
    recomb_cnt: jnp.ndarray  # [..., E]


def zero_stats(E: int, Pp: int, lead: tuple = ()) -> SuffStats:
    z = lambda *s: jnp.zeros(lead + s, dtype=jnp.float32)
    return SuffStats(
        coal_opp=z(E, Pp),
        coal_cnt=z(E, Pp),
        mig_opp=z(E, Pp),
        mig_cnt=z(E, Pp, Pp),
        recomb_opp=z(E),
        recomb_cnt=z(E),
    )


# --- flat layout -----------------------------------------------------------
# Inside the sweep the six statistic tensors live CONCATENATED in one flat
# [..., K] array: the scan/while/cond carries then move ONE buffer instead
# of six, and every push/commit/rotate is a single fused op.  A profiler
# trace of the scan showed ~58 buffer copies per segment (0.8 ms/segment,
# ~40% of the sweep) caused by multi-buffer carries and cond pass-throughs.


def stats_field_shapes(E: int, Pp: int):
    return [(E, Pp), (E, Pp), (E, Pp), (E, Pp, Pp), (E,), (E,)]


def stats_width(E: int, Pp: int) -> int:
    return sum(int(np.prod(s)) for s in stats_field_shapes(E, Pp))


def pack_stats(s: SuffStats) -> jnp.ndarray:
    """SuffStats -> flat [..., K] (lead axes preserved)."""
    shapes = stats_field_shapes(*s.coal_opp.shape[-2:])
    lead = s.coal_opp.shape[: s.coal_opp.ndim - 2]
    flat = [
        f.reshape(lead + (int(np.prod(sh)),))
        for f, sh in zip(s, shapes)
    ]
    return jnp.concatenate(flat, axis=-1)


def unpack_stats(flat, E: int, Pp: int) -> SuffStats:
    """flat [..., K] -> SuffStats (works for numpy or jax arrays)."""
    shapes = stats_field_shapes(E, Pp)
    lead = flat.shape[:-1]
    out, off = [], 0
    for sh in shapes:
        k = int(np.prod(sh))
        out.append(flat[..., off:off + k].reshape(lead + sh))
        off += k
    return SuffStats(*out)


def pack_epoch_masks(masks: SuffStats, E: int, Pp: int) -> jnp.ndarray:
    """Per-field [E] masks -> one flat [K] mask (broadcast per field)."""
    shapes = stats_field_shapes(E, Pp)
    parts = []
    for m, sh in zip(masks, shapes):
        reps = int(np.prod(sh)) // E
        parts.append(jnp.repeat(m, reps))
    return jnp.concatenate(parts)


def _pp_from_width(E: int, K: int) -> int:
    """Invert stats_width: K = E*(3*Pp + Pp^2 + 2)."""
    for Pp in range(1, 65):
        if stats_width(E, Pp) == K:
            return Pp
    raise ValueError(f"no Pp matches E={E}, K={K}")


def _pick_node(arr: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """arr[p, idx[p]] over the node axis as a one-hot reduction (arr
    [P, N, ...], idx [P])."""
    N = arr.shape[1]
    oh = (idx[:, None] == jnp.arange(N)[None, :]).reshape(
        idx.shape[0], N, *([1] * (arr.ndim - 2))
    )
    return jnp.sum(jnp.where(oh, arr, jnp.zeros_like(arr)), axis=1)


def _bcast_epoch(mask_e: jnp.ndarray, field: jnp.ndarray, lead_dims: int):
    """Broadcast an [E] mask against a [<lead>, E, ...] field."""
    shape = (1,) * lead_dims + (mask_e.shape[0],) + (1,) * (field.ndim - lead_dims - 1)
    return mask_e.reshape(shape)


# ---------------------------------------------------------------------------
# configuration and state
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PFConfig:
    """Static sweep configuration (reference flags at pfparam.cpp:63-169)."""

    num_particles: int
    num_leaves: int
    ess_threshold: float = 0.5  # resample when ESS < frac * P (pfparam.cpp:230)
    fifo_slots: int = 4  # lag FIFO depth
    ancestral_aware: bool = False
    max_recomb_iters: int = 64  # safety bound on the inner while loop
    has_migration: bool = False  # continuous migration in the proposal walk
    max_walk_events: int = 256  # event bound for the migration walk
    # total out-migration rate identical across populations in every epoch
    # AND exactly two populations (symmetric island/split models): enables
    # the scan-free CTMC path sampler in the jump walk (transition.py)
    mig_uniform: bool = False
    # jump-walk budgets (0 = derive from max_mig): CTMC path jumps per
    # lineage and global compacted branch-event capacity; sized by the
    # driver from the model's expected event counts (em._auto_mig_sizes)
    mig_jumps: int = 0
    mig_compact: int = 0
    use_bias: bool = False  # height-biased recombination sampling
    max_mig: int = 16  # per-branch migration-event buffer capacity (unused
    # buffers are omitted entirely when has_migration is False)
    apf: int = 0  # auxiliary-particle-filter level 0-4 (-apf, particle.cpp:439)
    delay_slots: int = 32  # delayed-importance-factor ring capacity
    delay_k: int = 3  # k-step geometric application (particle.cpp:891)
    record_arg: bool = False  # keep a per-particle ARG event log (-arg)
    # delayed-IW reference height (pfparam.hpp:282, particle.cpp:874-876):
    # "recomb" = recombination point (default), "coal" = first coalescence
    # (-delay_coal), "migr" = first coal-or-migration event (-delay_migr)
    delay_type: str = "recomb"
    arg_slots: int = 512  # ring capacity of the ARG log (newest kept)
    # local recombination-guide recording (reference count.cpp:559-654);
    # num_windows > 0 enables it.  Windows are chunk-relative.
    num_windows: int = 0  # ceil(chunk_len / window_size)
    window_size: float = 100.0  # local_recording_interval_ (count.hpp:115)
    local_ring: int = 32  # pending (lagged) local-recomb event capacity
    # recombination-guide consumption (pfparam.hpp:96-223): position-dependent
    # proposal rate + per-leaf tree guiding.  Set by the EM driver when a
    # guide file is active (-alpha > 0, model.py:1125-1143).
    use_guide: bool = False
    # in-proposal variational-Bayes correction (particle.cpp:266-272): each
    # recorded coal/migration event multiplies the weight by
    # exp(digamma(C))/C with C the rate's event count from the previous EM
    # iteration, i.e. the E_q[log rate] Gamma-posterior correction
    use_vb: bool = False

    @property
    def desc_words(self) -> int:
        """u32 words per descendant bitmask: 1 for <=32 leaves, 2 up to the
        reference's 64-leaf Descendants_t contract (descendants.hpp:16)."""
        if self.num_leaves > 64:
            raise ValueError(
                "descendant recording supports at most 64 sample haplotypes "
                f"(got {self.num_leaves}); reference has the same u64 cap"
            )
        return 1 if self.num_leaves <= 32 else 2


class PFState(NamedTuple):
    trees: Trees
    log_w: jnp.ndarray  # [P] normalized log posterior weights
    log_pilot: jnp.ndarray  # [P] pilot (sampling) weights; == log_w w/o bias
    next_rec: jnp.ndarray  # [P] next recombination pos rel. to sweep front
    fifo: jnp.ndarray  # [P, F, K] pending lagged statistics (flat layout)
    slot_open: jnp.ndarray  # [E] abs position where the newest slot opened
    stats: jnp.ndarray  # [K] committed, posterior-weighted (flat layout)
    stats_wt: jnp.ndarray  # [K] committed, w^2-weighted (post-lag ESS)
    ln_norm: jnp.ndarray  # [] accumulated log normalizer (log-likelihood)
    ln_norm_c: jnp.ndarray  # [] Kahan compensation
    front: jnp.ndarray  # [] sweep position (f32, chunk-relative)
    key: jnp.ndarray
    num_resamples: jnp.ndarray  # [] i32
    # delayed importance factors (reference DelayedFactor priority queue,
    # particle.hpp:59-101, as a fixed ring; free slots have pos == INF)
    df_pos: jnp.ndarray  # [P, K] application position (abs)
    df_logf: jnp.ndarray  # [P, K] log factor applied per activation
    df_delta: jnp.ndarray  # [P, K] spacing; doubles per activation
    df_k: jnp.ndarray  # [P, K] remaining activations
    # ARG event log ring (reference RECORD_TREE_EVENT chain ->
    # .trees.gz, particleContainer.cpp:515-555); None unless record_arg
    arg_pos: jnp.ndarray = None  # [P, A]
    arg_code: jnp.ndarray = None  # [P, A] 0=R 1=C 2=M
    arg_time: jnp.ndarray = None  # [P, A]
    arg_from: jnp.ndarray = None  # [P, A]
    arg_to: jnp.ndarray = None  # [P, A]
    arg_desc: jnp.ndarray = None  # [P, A, dw] u32 leaf bitmask words (<=64 leaves)
    arg_n: jnp.ndarray = None  # [P] total events pushed (ring index)
    # local recombination-guide recording (count.cpp:559-613): global window
    # accumulators + a per-particle pending-event ring committed with the
    # particle's then-current weight once the front passes pos + lag
    win_opp_diff: jnp.ndarray = None  # [W+1] differential opportunity density
    win_leaf_cnt: jnp.ndarray = None  # [W, n] per-leaf event counts
    win_time_cnt: jnp.ndarray = None  # [W] time-weighted counts
    win_logtime_cnt: jnp.ndarray = None  # [W] log-time-weighted counts
    lr_pos: jnp.ndarray = None  # [P, R] event position (INF = free slot)
    lr_due: jnp.ndarray = None  # [P, R] commit position (pos + lag[epoch(h)])
    lr_time: jnp.ndarray = None  # [P, R] recombination height
    lr_desc: jnp.ndarray = None  # [P, R, dw] u32 bitmask words of the cut branch
    lr_dropped: jnp.ndarray = None  # [] i32 ring-overflow counter
    # approximation-pressure diagnostics: [0] = migration walks that hit
    # max_walk_events (force-coalesced), [1] = migration events dropped on
    # buffer overflow.  Nonzero values flag silent bias; reported per chunk.
    diag: jnp.ndarray = None  # [2] f32


def init_state(
    key: jnp.ndarray,
    epochs: Epochs,
    cfg: PFConfig,
    sample_pop: np.ndarray,
    rho: float,
    sample_time: np.ndarray | None = None,
    guide=None,
) -> PFState:
    """Draw the initial particle population (particleContainer.cpp:33-65).

    ``guide`` = (g_rate [W], g_leaf [W, n]) makes the first recombination
    gap follow the position-dependent guide rate (see make_segment_step)."""
    P = cfg.num_particles
    E, Pp = epochs.num_epochs, epochs.num_pops
    k_tree, k_gap, key = jax.random.split(key, 3)
    trees = make_initial_trees(
        k_tree, epochs, P, jnp.asarray(sample_pop),
        None if sample_time is None else jnp.asarray(sample_time),
        max_mig=cfg.max_mig if cfg.has_migration else 0,
    )
    treelen = jax.vmap(
        lambda t, p: jnp.sum(jnp.where(p < 0, 0.0, t[jnp.clip(p, 0, None)] - t))
    )(trees.time, trees.parent)
    gap_m = jax.random.exponential(k_gap, (P,)) / jnp.maximum(
        rho * treelen, 1e-30
    )
    if guide is not None and cfg.use_guide:
        ws = float(cfg.window_size)
        g_rel = jnp.asarray(guide[0], jnp.float32) / max(float(rho), 1e-38)
        cum = jnp.concatenate([jnp.zeros(1), jnp.cumsum(g_rel * ws)])
        j = jnp.clip(
            jnp.searchsorted(cum, gap_m, side="right") - 1,
            0, g_rel.shape[0] - 1,
        )
        gap = j * ws + (gap_m - cum[j]) / jnp.maximum(g_rel[j], 1e-30)
    else:
        gap = gap_m
    from .kernels.tree import INF

    # delayed-factor ring is only used under bias/guide sampling; capacity
    # 1 keeps the dead buffers out of the scan/while carries (not 0: orbax
    # cannot checkpoint zero-size arrays)
    K = cfg.delay_slots if (cfg.use_bias or cfg.use_guide) else 1
    return PFState(
        trees=trees,
        log_w=jnp.full((P,), -jnp.log(float(P))),
        log_pilot=jnp.full((P,), -jnp.log(float(P))),
        next_rec=gap,
        fifo=jnp.zeros((P, cfg.fifo_slots, stats_width(E, Pp))),
        slot_open=jnp.zeros((E,)),
        stats=jnp.zeros((stats_width(E, Pp),)),
        stats_wt=jnp.zeros((stats_width(E, Pp),)),
        ln_norm=jnp.float32(0.0),
        ln_norm_c=jnp.float32(0.0),
        front=jnp.float32(0.0),
        key=key,
        num_resamples=jnp.int32(0),
        diag=jnp.zeros((2,)),
        df_pos=jnp.full((P, K), INF),
        df_logf=jnp.zeros((P, K)),
        df_delta=jnp.zeros((P, K)),
        df_k=jnp.zeros((P, K), jnp.int32),
        **_init_arg_ring(trees, cfg),
        **(
            dict(
                win_opp_diff=jnp.zeros((cfg.num_windows + 1,)),
                win_leaf_cnt=jnp.zeros((cfg.num_windows, cfg.num_leaves)),
                win_time_cnt=jnp.zeros((cfg.num_windows,)),
                win_logtime_cnt=jnp.zeros((cfg.num_windows,)),
                lr_pos=jnp.full((P, cfg.local_ring), INF),
                lr_due=jnp.full((P, cfg.local_ring), INF),
                lr_time=jnp.zeros((P, cfg.local_ring)),
                lr_desc=jnp.zeros(
                    (P, cfg.local_ring, cfg.desc_words), jnp.uint32
                ),
                lr_dropped=jnp.int32(0),
            )
            if cfg.num_windows > 0
            else {}
        ),
    )


def _init_arg_ring(trees: Trees, cfg: PFConfig) -> dict:
    """ARG-event ring, pre-seeded with the initial tree at position 0: one
    C row per internal node (height, population, descendant cluster) and M
    rows for per-branch migration events — the reference's event chain
    includes the initial tree's events too (buildInitialTree records into
    the same chain, particleContainer.cpp:33-65), and the tskit conversion
    needs the starting topology."""
    if not cfg.record_arg:
        return dict(arg_pos=None, arg_code=None, arg_time=None,
                    arg_from=None, arg_to=None, arg_desc=None, arg_n=None)
    P, N = trees.parent.shape
    n = (N + 1) // 2
    A = cfg.arg_slots
    dw = cfg.desc_words
    if dw == 1:
        from .kernels.tree import descendant_bitmask

        desc = jax.vmap(descendant_bitmask)(
            None, trees.time, trees.parent
        )[:, :, None]  # [P, N, 1]
    else:
        from .kernels.tree import descendant_bitmask64

        lo, hi = jax.vmap(descendant_bitmask64)(
            None, trees.time, trees.parent
        )
        desc = jnp.stack([lo, hi], axis=-1)  # [P, N, 2]

    k = n - 1  # internal nodes occupy ring slots 0..n-2
    arg_pos = jnp.zeros((P, A))
    arg_code = jnp.zeros((P, A), jnp.int8).at[:, :k].set(1)
    arg_time = jnp.zeros((P, A)).at[:, :k].set(trees.time[:, n:])
    arg_from = jnp.full((P, A), -1, jnp.int8).at[:, :k].set(
        trees.pop[:, n:].astype(jnp.int8)
    )
    arg_to = jnp.full((P, A), -1, jnp.int8)
    arg_desc = jnp.zeros((P, A, dw), jnp.uint32).at[:, :k].set(desc[:, n:])
    arg_n = jnp.full((P,), k, jnp.int32)
    arg = (arg_pos, arg_code, arg_time, arg_from, arg_to, arg_desc, arg_n)
    if trees.mig_time is not None:
        # M rows for the initial trees' branch migration events (capped at
        # the first 4 per branch, as in the per-transition recording)
        Mw = trees.mig_time.shape[2]
        for b in range(N):
            src = trees.pop[:, b]
            for j in range(min(4, Mw)):
                t_ev = trees.mig_time[:, b, j]
                have = t_ev < 0.5 * INF
                dst = trees.mig_dest[:, b, j]
                arg = _push_arg_event(
                    arg, have, jnp.zeros((P,)), 2, t_ev,
                    src.astype(jnp.int8), dst.astype(jnp.int8),
                    desc[:, b], A,
                )
                src = jnp.where(have, dst, src)
    return dict(
        arg_pos=arg[0], arg_code=arg[1], arg_time=arg[2], arg_from=arg[3],
        arg_to=arg[4], arg_desc=arg[5], arg_n=arg[6],
    )


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _tree_summaries(trees: Trees, epochs: Epochs, leaf_status: jnp.ndarray,
                    has_data: jnp.ndarray):
    """treelen [P], treelen_e [P, E], data branch length B [P].

    ``leaf_status`` is a per-segment scalar (-1 all-missing / 0 mixed / 1
    complete); the expensive mixed-data branch (ancestor-chain scatter,
    particle.cpp:699-730) only executes for mixed segments via lax.switch."""
    tl_e = jax.vmap(
        lambda t, p: branch_length_per_epoch(t, p, epochs.start, epochs.end)
    )(trees.time, trees.parent)
    tl = jnp.sum(tl_e, axis=1)

    def b_missing():
        return jnp.zeros_like(tl)

    def b_mixed():
        return jax.vmap(
            lambda t, p: data_branch_length(t, p, None, has_data)
        )(trees.time, trees.parent)

    def b_complete():
        return tl

    B = jax.lax.switch(
        jnp.clip(leaf_status.astype(jnp.int32) + 1, 0, 2),
        [b_missing, b_mixed, b_complete],
    )
    return tl, tl_e, B


def systematic_resample(key: jnp.ndarray, log_w: jnp.ndarray) -> jnp.ndarray:
    """Doucet-style stratified inverse-CDF resampling
    (particleContainer.cpp:474-504). Returns [P] ancestor indices."""
    P = log_w.shape[0]
    w = jax.nn.softmax(log_w)
    cum = jnp.cumsum(w)
    u = jax.random.uniform(key, (), minval=0.0, maxval=1.0)
    targets = (u + jnp.arange(P, dtype=jnp.float32)) / P
    return jnp.clip(jnp.searchsorted(cum, targets, side="left"), 0, P - 1).astype(
        jnp.int32
    )


def _gather_particles(state: PFState, idx: jnp.ndarray) -> PFState:
    """Ancestry gather: trees, pending FIFO and delayed factors follow the
    particle (reference: copy constructor particle.cpp:113-136)."""
    g = lambda x: jnp.take(x, idx, axis=0)
    state = state._replace(
        trees=jax.tree_util.tree_map(g, state.trees),
        fifo=jax.tree_util.tree_map(g, state.fifo),
        next_rec=g(state.next_rec),
        df_pos=g(state.df_pos),
        df_logf=g(state.df_logf),
        df_delta=g(state.df_delta),
        df_k=g(state.df_k),
    )
    if state.lr_pos is not None:
        state = state._replace(
            lr_pos=g(state.lr_pos), lr_due=g(state.lr_due),
            lr_time=g(state.lr_time), lr_desc=g(state.lr_desc),
        )
    if state.arg_pos is not None:
        state = state._replace(
            arg_pos=g(state.arg_pos), arg_code=g(state.arg_code),
            arg_time=g(state.arg_time), arg_from=g(state.arg_from),
            arg_to=g(state.arg_to), arg_desc=g(state.arg_desc),
            arg_n=g(state.arg_n),
        )
    return state


def _push_delayed(df_pos, df_logf, df_delta, df_k, mask, pos, delay, log_iw, kk):
    """Insert k-step geometric delayed factors (particle.hpp:63-82): final
    application at pos+delay; k applications of factor^(1/k) at doubling
    intervals delta, 2*delta, ... with delta = delay/(2^k - 1).  If the ring
    is full, the whole factor is applied immediately (returned as an additive
    pilot-weight correction)."""
    from .kernels.tree import INF

    K = df_pos.shape[1]
    free = df_pos >= 0.5 * INF
    has_free = jnp.any(free, axis=1)
    slot = jnp.argmax(free, axis=1)
    delta = delay / (2.0**kk - 1.0)
    do = mask & has_free
    # masked select over the slot axis (scatter-free)
    hit = (jnp.arange(K)[None, :] == slot[:, None]) & do[:, None]  # [P, K]
    df_pos = jnp.where(hit, jnp.broadcast_to(pos + delta, do.shape)[:, None], df_pos)
    df_logf = jnp.where(hit, jnp.broadcast_to(log_iw / kk, do.shape)[:, None], df_logf)
    df_delta = jnp.where(hit, jnp.broadcast_to(delta, do.shape)[:, None], df_delta)
    df_k = jnp.where(hit, jnp.int32(kk), df_k)
    overflow_add = jnp.where(mask & ~has_free, log_iw, 0.0)
    return df_pos, df_logf, df_delta, df_k, overflow_add


def _push_arg_event(arg, mask, pos, code, time, from_pop, to_pop, desc, A):
    """Masked ring push of one ARG event per particle (newest-kept ring)."""
    arg_pos, arg_code, arg_time, arg_from, arg_to, arg_desc, arg_n = arg
    P = arg_n.shape[0]
    slot = arg_n % A
    hit2 = (jnp.arange(A)[None, :] == slot[:, None]) & mask[:, None]  # [P, A]

    def setm(a, v):
        # masked select over the ring axis (scatter-free)
        m = hit2.reshape(hit2.shape + (1,) * (a.ndim - 2))
        vb = jnp.broadcast_to(
            v.astype(a.dtype)[:, None] if a.ndim == 2 else
            v.astype(a.dtype)[:, None, :], a.shape
        )
        return jnp.where(m, vb, a)
    arg_pos = setm(arg_pos, pos)
    arg_code = setm(arg_code, jnp.full((P,), code, jnp.int8))
    arg_time = setm(arg_time, time)
    arg_from = setm(arg_from, from_pop.astype(jnp.int8))
    arg_to = setm(
        arg_to, jnp.broadcast_to(jnp.asarray(to_pop, jnp.int8), (P,))
    )
    arg_desc = setm(arg_desc, desc)
    arg_n = arg_n + mask.astype(jnp.int32)
    return (arg_pos, arg_code, arg_time, arg_from, arg_to, arg_desc, arg_n)


def _apply_due_delayed(df_pos, df_logf, df_delta, df_k, front):
    """Apply all factors whose application position has been passed
    (particle.cpp:911-916 + applyDelayedAdjustment, particle.hpp:199-209).
    Returns the additive log-pilot update and the new ring."""
    from .kernels.tree import INF

    due = df_pos <= front
    add = jnp.sum(jnp.where(due, df_logf, 0.0), axis=1)
    again = due & (df_k > 1)
    done = due & (df_k <= 1)
    df_pos = jnp.where(again, df_pos + 2.0 * df_delta, jnp.where(done, INF, df_pos))
    df_delta = jnp.where(again, 2.0 * df_delta, df_delta)
    df_k = jnp.where(again, df_k - 1, jnp.where(done, 0, df_k))
    df_logf = jnp.where(done, 0.0, df_logf)
    return add, df_pos, df_logf, df_delta, df_k


def _push_local_event(lr, mask, pos, due, height, desc):
    """Insert one pending local-recomb event per masked particle into the
    first free ring slot (count.cpp:595-613 event columns; the ring models
    the reference's lagged commit).  Overflow drops the event (counted)."""
    lr_pos, lr_due, lr_time, lr_desc, lr_dropped = lr
    R = lr_pos.shape[1]
    free = lr_pos >= 0.5 * INF
    has_free = jnp.any(free, axis=1)
    slot = jnp.argmax(free, axis=1)
    do = mask & has_free
    hit = (jnp.arange(R)[None, :] == slot[:, None]) & do[:, None]  # [P, R]
    lr_pos = jnp.where(hit, pos[:, None], lr_pos)
    lr_due = jnp.where(hit, due[:, None], lr_due)
    lr_time = jnp.where(hit, height[:, None], lr_time)
    lr_desc = jnp.where(hit[:, :, None], desc[:, None, :], lr_desc)
    lr_dropped = lr_dropped + jnp.sum(mask & ~has_free).astype(jnp.int32)
    return (lr_pos, lr_due, lr_time, lr_desc, lr_dropped)


def _add_window_opportunity(win_opp_diff, x_start, x_end, total_opp, ws):
    """Differential per-window opportunity-density update
    (count.cpp:563-587): the density is spread over [x_start, x_end) with
    fractional first/last windows; cumsum at dump time recovers the
    per-window density."""
    W = win_opp_diff.shape[0] - 1
    span = x_end - x_start
    ok = span > 0
    dens = jnp.where(ok, total_opp / jnp.maximum(span, 1e-30), 0.0)
    fi = jnp.floor(x_start / ws).astype(jnp.int32)
    li = jnp.floor(x_end / ws).astype(jnp.int32) + 1
    f_int = jnp.minimum((fi + 1).astype(jnp.float32) * ws, x_end) - x_start
    l_int = x_end - jnp.maximum((li - 1).astype(jnp.float32) * ws, x_start)
    single = fi == li - 1
    idx = jnp.stack([fi, fi + 1, li - 1, li])
    vals = jnp.where(
        single,
        jnp.stack([f_int * dens, -f_int * dens, 0.0, 0.0]),
        jnp.stack(
            [f_int * dens, (ws - f_int) * dens, (l_int - ws) * dens,
             -l_int * dens]
        ),
    )
    idx = jnp.clip(idx, 0, W)
    return win_opp_diff.at[idx].add(jnp.where(ok, vals, 0.0))


def _commit_due_local(state: PFState, w: jnp.ndarray, front, ws: float):
    """Scatter pending local-recomb events whose commit position has been
    passed into the global window accumulators, weighted by the particles'
    current normalized weights (count.cpp:595-613 semantics: weight at the
    lagged commit, 1/num_descendants per descendant leaf, plus time and
    log(time+1) columns)."""
    W, n = state.win_leaf_cnt.shape
    due = state.lr_due <= front  # [P, R]
    widx = jnp.clip((state.lr_pos / ws).astype(jnp.int32), 0, W - 1)
    word = jnp.arange(n) // 32  # [n] u32 word holding each leaf's bit
    bits = (
        state.lr_desc[:, :, word] >> jnp.arange(n, dtype=jnp.uint32) % 32
    ) & jnp.uint32(1)  # [P, R, n]
    nd = jnp.maximum(jnp.sum(bits, axis=-1), 1).astype(jnp.float32)  # [P, R]
    wt = jnp.where(due, w[:, None], 0.0)  # [P, R]
    leaf_vals = (wt / nd)[:, :, None] * bits.astype(jnp.float32)  # [P, R, n]
    flat_idx = (widx[:, :, None] * n + jnp.arange(n)).reshape(-1)
    win_leaf_cnt = (
        state.win_leaf_cnt.reshape(-1)
        .at[flat_idx]
        .add(leaf_vals.reshape(-1))
        .reshape(W, n)
    )
    win_time_cnt = state.win_time_cnt.at[widx.reshape(-1)].add(
        (wt * state.lr_time).reshape(-1)
    )
    win_logtime_cnt = state.win_logtime_cnt.at[widx.reshape(-1)].add(
        (wt * jnp.log(state.lr_time + 1.0)).reshape(-1)
    )
    return state._replace(
        win_leaf_cnt=win_leaf_cnt,
        win_time_cnt=win_time_cnt,
        win_logtime_cnt=win_logtime_cnt,
        lr_pos=jnp.where(due, INF, state.lr_pos),
        lr_due=jnp.where(due, INF, state.lr_due),
    )


def _commit_slot(
    state: PFState, rotate_e: jnp.ndarray, slot: int, rotate: bool = True
) -> PFState:
    """Commit FIFO slot ``slot`` for the epochs in ``rotate_e`` using the
    particles' current normalized weights (count.cpp:448-555 semantics),
    then (optionally) rotate those epochs' FIFOs one slot."""
    w = jax.nn.softmax(state.log_w)  # [P]
    E = rotate_e.shape[0]
    K = state.fifo.shape[2]
    Pp = _pp_from_width(E, K)
    rot_flat = pack_epoch_masks(
        SuffStats(*([rotate_e.astype(jnp.float32)] * 6)), E, Pp
    )  # [K]
    x = state.fifo[:, slot]  # [P, K]
    stats = state.stats + rot_flat * jnp.sum(x * w[:, None], axis=0)
    stats_wt = state.stats_wt + rot_flat * jnp.sum(
        x * (w**2)[:, None], axis=0
    )
    fifo = state.fifo
    if rotate:
        rolled = jnp.roll(fifo, 1, axis=1)
        zeroed = rolled.at[:, 0].set(0.0)
        fifo = jnp.where(rot_flat[None, None, :] > 0, zeroed, fifo)
    return state._replace(stats=stats, stats_wt=stats_wt, fifo=fifo)


def flush_pending(state: PFState, window_size: float = 100.0) -> PFState:
    """End-of-data flush: commit every pending slot with current weights
    (count.cpp:366, lag -> 0 at end_data); pending local-recomb events
    commit likewise.  Slots are committed WITHOUT rotating — the old
    commit-and-rotate loop silently skipped half the slots (incl. slot 0,
    which holds everything when the lag exceeds the chunk length)."""
    w = jax.nn.softmax(state.log_w)
    total = jnp.sum(state.fifo, axis=1)  # [P, K] all pending slots
    state = state._replace(
        stats=state.stats + jnp.sum(total * w[:, None], axis=0),
        stats_wt=state.stats_wt + jnp.sum(total * (w**2)[:, None], axis=0),
        fifo=jnp.zeros_like(state.fifo),
    )
    if state.lr_pos is not None:
        state = _commit_due_local(
            state, jax.nn.softmax(state.log_w), jnp.float32(INF), window_size
        )
    return state


# ---------------------------------------------------------------------------
# one segment step
# ---------------------------------------------------------------------------


def make_segment_step(cfg: PFConfig, epochs: Epochs, mutation_rate, rho, lags,
                      bias_heights=None, bias_strengths=None, delays=None,
                      tblq=None, guide=None, vb_tables=None, rec_masks=None):
    """Build the per-segment scan body.

    ``epochs``, ``mutation_rate``, ``rho`` and ``lags`` may be traced values
    (see :func:`build_sweep`) so that EM iterations and chunks reuse one
    compiled program — the reference pays a fresh process launch per
    (iteration, chunk) instead (model.py:1050-1100).

    Segment input (see segio): length (i32), alleles [n] (i8), state (i8),
    leaf_status (i8: -1 all-missing / 0 mixed / 1 complete).

    ``guide`` = (g_rate [W], g_leaf [W, n]): per-window posterior-weighted
    recombination rates and per-leaf relative rates (the parsed guide file,
    pfparam.hpp:96-223).  Recombination positions are then sampled from the
    position-dependent rate — implemented not as the reference's
    rate-change-event walk (sampleNextBase, particle.cpp:1195+) but by a
    change of coordinates: in "guide mass" m(x) = (1/rho)·∫ g_rate dx the
    process is homogeneous with the usual rho·treelen hazard, so one
    searchsorted maps each exponential draw back to a genome position.  The
    survival importance weight exp(sampled-target) per extension segment
    matches importance_weight_over_segment (particle.cpp:1138-1182); like
    the reference, the point-density ratio rho/g_rate(x) at the event itself
    is not corrected.
    """
    P = cfg.num_particles
    E, Pp = epochs.num_epochs, epochs.num_pops
    F = cfg.fifo_slots
    span = lags / jnp.maximum(F - 1, 1)  # per-epoch FIFO slot span
    mu = jnp.float32(mutation_rate)
    rho = jnp.float32(rho)
    record_local = cfg.num_windows > 0
    ws = float(cfg.window_size)
    # pilot weights diverge from the posterior only under biased/guided
    # sampling or the APF; otherwise every pilot update is dead work in the
    # hot loop (log_pilot := log_w at the end of each step)
    track_pilot = cfg.use_bias or cfg.use_guide or cfg.apf > 0
    K = stats_width(E, Pp)
    # static slice offset of recomb_opp in the flat layout
    _off = 0
    for _name, _sh in zip(SuffStats._fields, stats_field_shapes(E, Pp)):
        if _name == "recomb_opp":
            break
        _off += int(np.prod(_sh))
    OFF_RECOMB_OPP = _off
    # recording-time epoch exclusion masks (-xc / -xr): the reference gates
    # event RECORDING per epoch via record_event_in_epoch
    # (pfparam.cpp:82-99), not just the M-step aggregate
    if rec_masks is None:
        xc_mask = xr_mask = jnp.ones((E,), jnp.float32)
    else:
        xc_mask, xr_mask = rec_masks

    if cfg.use_guide:
        g_rate, g_leaf = guide
        Wg = g_rate.shape[0]
        g_rel = g_rate / jnp.maximum(rho, 1e-38)  # ~1; keeps mass in bp units
        cum_mass = jnp.concatenate(
            [jnp.zeros(1), jnp.cumsum(g_rel * ws)]
        )  # [Wg+1] effective-bp mass at window boundaries

        def mass(x):
            i = jnp.clip(jnp.floor(x / ws).astype(jnp.int32), 0, Wg - 1)
            return cum_mass[i] + (x - i * ws) * g_rel[i]

        def inv_mass(m):
            j = jnp.clip(
                jnp.searchsorted(cum_mass, m, side="right") - 1, 0, Wg - 1
            )
            return j * ws + (m - cum_mass[j]) / jnp.maximum(g_rel[j], 1e-30)

        def draw_gap(sub, tl, abs_pos):
            """Next recombination distance from abs_pos under the guide."""
            gap_m = jax.random.exponential(sub, (P,)) / jnp.maximum(
                rho * tl, 1e-30
            )
            nxt = inv_mass(mass(abs_pos) + gap_m)
            return jnp.maximum(nxt - abs_pos, 1e-3)

        def span_log_iw(tl, x0, x1):
            """log survival IW over [x0, x1): sampled minus target hazard."""
            dm = mass(x1) - mass(x0)
            return rho * tl * (dm - (x1 - x0))

    else:

        def draw_gap(sub, tl, abs_pos):
            return jax.random.exponential(sub, (P,)) / jnp.maximum(
                rho * tl, 1e-30
            )

    def step(state: PFState, seg):
        # configs: [C, n] phase configurations for the segment-final site
        # (C == 1 for fully phased data); likelihood is averaged over the
        # first n_configs of them (particleContainer.cpp:212-224)
        if cfg.apf > 0:
            (seg_len, configs, n_configs, seg_state, leaf_status, dist_mut,
             *la_seg) = seg
            la_seg = tuple(la_seg)
        else:
            (seg_len, configs, n_configs, seg_state, leaf_status,
             dist_mut) = seg
            la_seg = None
        L = seg_len.astype(jnp.float32)
        has_data = configs[0] >= 0

        # ---- inner recombination loop over the window [front, front+L) ----
        def summaries(trees):
            return _tree_summaries(trees, epochs, leaf_status, has_data)

        tl, tl_e, B = summaries(state.trees)

        def cond(carry):
            next_rec, it = carry[7], carry[-1]
            return jnp.any(next_rec < L) & (it < cfg.max_recomb_iters)

        def body(carry):
            (key, trees, log_w, log_pilot, dfs, arg, lr, next_rec, upd, tl,
             tl_e, B, pending, diag, it) = carry
            active = next_rec < L
            if cfg.record_arg or record_local:
                # [P, N, dw] — recombining node's leaf set (pre-transition),
                # dw u32 words covering up to 64 leaves (descendants.hpp:16)
                if cfg.desc_words == 1:
                    from .kernels.tree import descendant_bitmask

                    desc_pre = jax.vmap(
                        lambda t, p: descendant_bitmask(None, t, p)
                    )(trees.time, trees.parent)[:, :, None]
                else:
                    from .kernels.tree import descendant_bitmask64

                    lo, hi = jax.vmap(
                        lambda t, p: descendant_bitmask64(None, t, p)
                    )(trees.time, trees.parent)
                    desc_pre = jnp.stack([lo, hi], axis=-1)
            delta = jnp.where(active, next_rec - upd, 0.0)
            # no-mutation likelihood over [upd, next_rec)
            log_w = log_w - mu * B * delta
            if track_pilot:
                log_pilot = log_pilot - mu * B * delta
            if cfg.use_guide:
                # survival IW for guide-rate position sampling, applied
                # immediately (particle.cpp:810-813,1138-1182)
                liw = jnp.where(
                    active,
                    span_log_iw(
                        tl, state.front + upd, state.front + next_rec
                    ),
                    0.0,
                )
                log_w = log_w + liw
                log_pilot = log_pilot + liw
            # recombination opportunity dx * treelen_e (coalevent.hpp:221)
            pending = pending.at[:, OFF_RECOMB_OPP:OFF_RECOMB_OPP + E].add(
                delta[:, None] * tl_e
            )
            # the transition itself
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, P)
            if cfg.use_guide:
                win = jnp.clip(
                    ((state.front + next_rec) / ws).astype(jnp.int32),
                    0, Wg - 1,
                )
                lrates = g_leaf[win]  # [P, n] guide rates at the event window
            else:
                lrates = None
            trees, rec = recombination_transition(
                keys, trees, epochs, active,
                has_migration=cfg.has_migration,
                max_events=cfg.max_walk_events,
                mig_uniform=cfg.mig_uniform,
                mig_jumps=cfg.mig_jumps,
                mig_compact=cfg.mig_compact,
                bias_heights=bias_heights if cfg.use_bias else None,
                bias_strengths=bias_strengths if cfg.use_bias else None,
                leaf_rates=lrates,
            )
            pending = pending + pack_stats(
                SuffStats(
                    coal_opp=rec.coal_opp, coal_cnt=rec.coal_cnt,
                    mig_opp=rec.mig_opp, mig_cnt=rec.mig_cnt,
                    recomb_opp=jnp.zeros_like(rec.recomb_cnt),
                    recomb_cnt=rec.recomb_cnt,
                )
            )
            diag = diag + jnp.stack(
                [jnp.sum(rec.walk_capped), jnp.sum(rec.buf_dropped)]
            )
            if cfg.use_vb:
                # variational-Bayes in-proposal correction: each recorded
                # coal/migration event carries log-factor psi(C) - log(C)
                # (particle.cpp:266-272 adjustWeights(exp_digamma(C)/C));
                # rec.*_cnt are already zero for inactive particles
                vb_coal, vb_mig = vb_tables
                # -xc epochs record no events, so no VB factor either
                vb_adj = jnp.sum(
                    rec.coal_cnt * (vb_coal * xc_mask[:, None])[None],
                    axis=(1, 2),
                ) + jnp.sum(
                    rec.mig_cnt * (vb_mig * xc_mask[:, None, None])[None],
                    axis=(1, 2, 3),
                )
                log_w = log_w + vb_adj
                if track_pilot:
                    log_pilot = log_pilot + vb_adj
            if cfg.use_bias or cfg.use_guide:
                # posterior gets the full IW immediately; the pilot gets the
                # height-bias part immediately when the point falls in an
                # unbiased section, and the rest (always including the guide
                # part) with a per-epoch delay (particle.cpp:869-891)
                log_w = log_w + jnp.where(active, rec.log_iw, 0.0)
                # delay reference height (particle.cpp:874-876): default is
                # the recombination point; -delay_coal/-delay_migr key the
                # delay (and the immediate-vs-delayed section lookup) off the
                # first coalescence / first coal-or-migration event instead
                if cfg.delay_type == "coal":
                    d_h = rec.coal_height
                elif cfg.delay_type == "migr":
                    d_h = rec.coal_height
                    if rec.mig_ev_t is not None:
                        first_mig = jnp.min(
                            jnp.where(
                                rec.mig_ev_t < 0.5 * INF, rec.mig_ev_t, INF
                            ),
                            axis=1,
                        )
                        d_h = jnp.minimum(d_h, first_mig)
                else:
                    d_h = rec.recomb_height
                if cfg.use_bias and cfg.delay_type != "recomb":
                    # re-derive the bias strength at the delay height
                    # (particle.cpp:877-879 section walk)
                    sec = jnp.clip(
                        jnp.searchsorted(bias_heights, d_h, side="right") - 1,
                        0, bias_strengths.shape[0] - 1,
                    )
                    strength_h = bias_strengths[sec]
                else:
                    strength_h = rec.point_strength
                immediate = jnp.abs(strength_h - 1.0) < 1e-6
                imm_log = jnp.where(immediate, rec.log_iw_bias, 0.0)
                del_log = rec.log_iw - imm_log
                log_pilot = log_pilot + jnp.where(active, imm_log, 0.0)
                e_h = _epoch_index(epochs.start, d_h)  # [P]
                delay = jnp.sum(
                    jnp.where(e_h[:, None] == jnp.arange(E)[None, :],
                              delays[None, :], 0.0),
                    axis=1,
                )
                abs_pos = state.front + next_rec
                df_pos, df_logf, df_delta, df_k = dfs
                df_pos, df_logf, df_delta, df_k, ovf = _push_delayed(
                    df_pos, df_logf, df_delta, df_k,
                    active & (jnp.abs(del_log) > 1e-9), abs_pos, delay,
                    del_log, cfg.delay_k,
                )
                log_pilot = log_pilot + ovf
                dfs = (df_pos, df_logf, df_delta, df_k)
            if cfg.record_arg:
                # R + C rows of the .trees event log
                # (particleContainer.cpp:515-555 format)
                dc = _pick_node(desc_pre, rec.c_node)  # [P, dw]
                # C rows carry the UNION of the cut lineage and the
                # coalesced-with subtree — the descendants of the new node,
                # matching the reference's event records (coalevent.hpp
                # add_leaf_to_tree semantics; trees2tskit.py relies on it)
                du = dc | _pick_node(desc_pre, rec.d_node)
                abs_pos = state.front + next_rec
                arg = _push_arg_event(
                    arg, active, abs_pos, 0, rec.recomb_height,
                    jnp.full((P,), -1, jnp.int8), -1, dc, cfg.arg_slots,
                )
                arg = _push_arg_event(
                    arg, active, abs_pos, 1, rec.coal_height,
                    rec.coal_pop, -1, du, cfg.arg_slots,
                )
                if rec.mig_ev_t is not None:
                    # M rows: realized migration hops on the new branch
                    # (particleContainer.cpp:541-547).  Cap at 4 per
                    # transition — more hops per single SPR is vanishingly
                    # rare at plausible rates.
                    from .kernels.tree import INF as _INF

                    for j in range(min(4, rec.mig_ev_t.shape[1])):
                        mv = active & (rec.mig_ev_t[:, j] < 0.5 * _INF)
                        arg = _push_arg_event(
                            arg, mv, abs_pos, 2, rec.mig_ev_t[:, j],
                            rec.mig_ev_from[:, j],
                            rec.mig_ev_to[:, j].astype(jnp.int8),
                            dc, cfg.arg_slots,
                        )
            if record_local:
                # pending local-recomb event: committed with the lag of the
                # recombination height's epoch (count.cpp:595-613)
                dc_l = _pick_node(desc_pre, rec.c_node)  # [P, dw]
                e_hl = _epoch_index(epochs.start, rec.recomb_height)
                lag_h = jnp.sum(
                    jnp.where(e_hl[:, None] == jnp.arange(E)[None, :],
                              lags[None, :], 0.0),
                    axis=1,
                )
                abs_pos_l = state.front + next_rec
                lr = _push_local_event(
                    lr, active, abs_pos_l, abs_pos_l + lag_h,
                    rec.recomb_height, dc_l,
                )
            # refresh tree summaries for particles that changed
            tl2, tl_e2, B2 = summaries(trees)
            tl = jnp.where(active, tl2, tl)
            tl_e = jnp.where(active[:, None], tl_e2, tl_e)
            B = jnp.where(active, B2, B)
            # draw next recombination position
            key, sub = jax.random.split(key)
            gap = draw_gap(sub, tl, state.front + next_rec)
            upd = jnp.where(active, next_rec, upd)
            next_rec = jnp.where(active, next_rec + gap, next_rec)
            return (key, trees, log_w, log_pilot, dfs, arg, lr, next_rec, upd,
                    tl, tl_e, B, pending, diag, it + 1)

        pending0 = jnp.zeros((P, K))
        arg0 = (
            (state.arg_pos, state.arg_code, state.arg_time, state.arg_from,
             state.arg_to, state.arg_desc, state.arg_n)
            if cfg.record_arg
            else ()
        )
        lr0 = (
            (state.lr_pos, state.lr_due, state.lr_time, state.lr_desc,
             state.lr_dropped)
            if record_local
            else ()
        )
        carry = (
            state.key,
            state.trees,
            state.log_w,
            state.log_pilot,
            (state.df_pos, state.df_logf, state.df_delta, state.df_k),
            arg0,
            lr0,
            state.next_rec,
            jnp.zeros((P,)),
            tl,
            tl_e,
            B,
            pending0,
            state.diag,
            jnp.int32(0),
        )
        (key, trees, log_w, log_pilot, dfs, arg, lr, next_rec, upd, tl, tl_e,
         B, pending, diag, _) = jax.lax.while_loop(
            cond, body, carry
        )
        df_pos, df_logf, df_delta, df_k = dfs

        # final extension to the segment end
        delta = L - upd
        log_w = log_w - mu * B * delta
        if track_pilot:
            log_pilot = log_pilot - mu * B * delta
        if cfg.use_guide:
            liw_f = jnp.where(
                delta > 0,
                span_log_iw(tl, state.front + upd, state.front + L),
                0.0,
            )
            log_w = log_w + liw_f
            log_pilot = log_pilot + liw_f
        pending = pending.at[:, OFF_RECOMB_OPP:OFF_RECOMB_OPP + E].add(
            delta[:, None] * tl_e
        )
        next_rec = next_rec - L

        # ---- site likelihood at the segment-final position ----------------
        def with_site(ws):
            lw, lp = ws
            C = configs.shape[0]
            if C == 1:
                ll = site_log_likelihood(
                    trees, configs[0], mu, cfg.ancestral_aware
                )
            else:
                # static Python loop over phase configurations (C <= 8): a
                # vmap here would wrap the likelihood's while_loop in
                # per-lane masking (see make_initial_trees)
                per_cfg = jnp.stack(
                    [
                        site_log_likelihood(
                            trees, configs[i], mu, cfg.ancestral_aware
                        )
                        for i in range(C)
                    ]
                )  # [C, P]
                mask = (jnp.arange(C) < n_configs)[:, None]
                ll = jax.scipy.special.logsumexp(
                    jnp.where(mask, per_cfg, -jnp.inf), axis=0
                ) - jnp.log(n_configs.astype(jnp.float32))
            return lw + ll, (lp + ll if track_pilot else lp)

        apply_site = (seg_state == 0) & (leaf_status != -1)  # SEGMENT_INVARIANT
        log_w, log_pilot = jax.lax.cond(
            apply_site, with_site, lambda ws: ws, (log_w, log_pilot)
        )

        # ---- push pending increments into FIFO slot 0 ---------------------
        # max_epoch_to_update (smcsmc.cpp:266-275): during long stretches
        # without an informative site ahead, epochs whose lag is shorter than
        # 2x the distance would commit their events before any data could
        # weigh them — suppress recording there (scale_factor 0.5)
        gate_e = (dist_mut < 0.5 * lags).astype(jnp.float32)  # [E]
        # -xc masks coal+migration recording, -xr masks recombination
        # recording (record_event_in_epoch, pfparam.cpp:82-99)
        mask_flat = pack_epoch_masks(
            SuffStats(
                coal_opp=gate_e * xc_mask, coal_cnt=gate_e * xc_mask,
                mig_opp=gate_e * xc_mask, mig_cnt=gate_e * xc_mask,
                recomb_opp=gate_e * xr_mask, recomb_cnt=gate_e * xr_mask,
            ),
            E, Pp,
        )  # [K]
        fifo = state.fifo.at[:, 0].add(pending * mask_flat[None, :])

        # ---- normalize ----------------------------------------------------
        delta_ln = jax.scipy.special.logsumexp(log_w)
        log_w = log_w - delta_ln
        # Kahan-compensated accumulation (LogL magnitudes reach 1e7+)
        y = delta_ln - state.ln_norm_c
        t = state.ln_norm + y
        ln_norm_c = (t - state.ln_norm) - y
        ln_norm = t

        front = state.front + L
        if cfg.use_bias or cfg.use_guide:
            # drain delayed factors that came due (particle.cpp:911-916);
            # the guide's per-point IW is delayed too (pfparam.hpp:96-223)
            add, df_pos, df_logf, df_delta, df_k = _apply_due_delayed(
                df_pos, df_logf, df_delta, df_k, front
            )
            log_pilot = log_pilot + add
            log_pilot = log_pilot - jax.scipy.special.logsumexp(log_pilot)
        else:
            log_pilot = log_w

        state = state._replace(
            trees=trees,
            log_w=log_w,
            log_pilot=log_pilot,
            next_rec=next_rec,
            fifo=fifo,
            ln_norm=ln_norm,
            ln_norm_c=ln_norm_c,
            front=front,
            key=key,
            df_pos=df_pos,
            df_logf=df_logf,
            df_delta=df_delta,
            df_k=df_k,
            diag=diag,
        )
        if cfg.record_arg:
            state = state._replace(
                arg_pos=arg[0], arg_code=arg[1], arg_time=arg[2],
                arg_from=arg[3], arg_to=arg[4], arg_desc=arg[5], arg_n=arg[6],
            )
        if record_local:
            # window opportunity density: this segment's recombination
            # opportunity (already summed over epochs in `pending`), weighted
            # by the current normalized weights and spread over [front-L,
            # front) (count.cpp:520-552 -> record_local_recomb_events)
            w_now = jax.nn.softmax(log_w)
            seg_ropp = jnp.sum(
                pending[:, OFF_RECOMB_OPP:OFF_RECOMB_OPP + E], axis=1
            )  # [P]
            total_opp = jnp.sum(w_now * seg_ropp)
            state = state._replace(
                win_opp_diff=_add_window_opportunity(
                    state.win_opp_diff, front - L, front, total_opp, ws
                ),
                lr_pos=lr[0], lr_due=lr[1], lr_time=lr[2], lr_desc=lr[3],
                lr_dropped=lr[4],
            )
            state = _commit_due_local(state, w_now, front, ws)

        # ---- lagged commit ------------------------------------------------
        # epochs rotate their FIFO only every `span` bp, so most segments
        # commit nothing; gate the ~30-kernel commit+rotate behind a cond
        rotate_e = (front - state.slot_open) >= span

        def do_commit(op):
            st = state._replace(stats=op[0], stats_wt=op[1], fifo=op[2])
            st = _commit_slot(st, rotate_e, F - 1)
            return (st.stats, st.stats_wt, st.fifo)

        stats2, stats_wt2, fifo2 = jax.lax.cond(
            jnp.any(rotate_e), do_commit, lambda op: op,
            (state.stats, state.stats_wt, state.fifo),
        )
        state = state._replace(
            stats=stats2, stats_wt=stats_wt2, fifo=fifo2,
            slot_open=jnp.where(rotate_e, front, state.slot_open),
        )

        # ---- ESS and resampling (on pilot weights; equal to posterior when
        # no bias is active) ------------------------------------------------
        # APF lookahead (particleContainer.cpp:228-243): the lookahead
        # likelihood of upcoming variants enters the *pilot* weight only, is
        # recomputed fresh each segment (include/remove cycle), and is
        # divided back out of the posterior at resampling — an auxiliary
        # particle filter, unbiased by construction.
        if cfg.apf > 0:
            from .kernels.lookahead import lookahead_loglik

            tblq_len, tblq_w, etbl = tblq
            la = lookahead_loglik(
                state.trees, tl, la_seg, tblq_len, tblq_w, etbl, mu, rho,
                cfg.apf,
            )
            pilot_eff = state.log_pilot + la
            pilot_eff = pilot_eff - jax.scipy.special.logsumexp(pilot_eff)
        else:
            pilot_eff = state.log_pilot
        wp = jax.nn.softmax(pilot_eff)
        ess = 1.0 / jnp.sum(wp * wp)

        def do_resample(state):
            key, k1, k2 = jax.random.split(state.key, 3)
            idx = systematic_resample(k1, pilot_eff)
            # auxiliary-PF reweight: w' = (w/pilot)[ancestor] / P
            lw = state.log_w - pilot_eff
            state = _gather_particles(state, idx)
            new_log_w = jnp.take(lw, idx) - jnp.log(float(P))
            # re-draw next recombination positions for clones; valid for all
            # by memorylessness of the exponential (particle.cpp:393-436)
            tl_r = jnp.take(tl, idx, axis=0)
            gap = draw_gap(k2, tl_r, jnp.full((P,), front))
            return state._replace(
                log_w=new_log_w,
                log_pilot=jnp.full((P,), -jnp.log(float(P))),
                next_rec=gap,
                key=key,
                num_resamples=state.num_resamples + 1,
            )

        need = (ess < cfg.ess_threshold * P) & (seg_len > 0)
        state = jax.lax.cond(need, do_resample, lambda s: s, state)
        # per-segment trace: ESS, whether a resample fired, and the genome
        # position — the .resample contract wants (position, ESS) at each
        # resample event (pfparam.cpp:530-538)
        return state, (ess, need, front)

    return step


def run_block(state: PFState, step_fn, seg_block) -> tuple[PFState, jnp.ndarray]:
    """Scan the sweep over one block of segments.

    seg_block: (lengths [S] i32, alleles [S, n] i8, states [S] i8,
    leaf_status [S] i8); zero-length segments are padding no-ops.
    """
    return jax.lax.scan(step_fn, state, seg_block)


@partial(jax.jit, static_argnums=(0,))
def _sweep_jit(cfg: PFConfig, state: PFState, seg_block, epochs: Epochs,
               mutation_rate, rho, lags, bias_heights, bias_strengths, delays,
               tblq, guide, vb_tables, rec_masks):
    step = make_segment_step(cfg, epochs, mutation_rate, rho, lags,
                             bias_heights, bias_strengths, delays, tblq,
                             guide, vb_tables, rec_masks)
    return jax.lax.scan(step, state, seg_block)


def build_sweep(cfg: PFConfig):
    """One compiled sweep program per (static config, shapes): demographic
    parameters are traced inputs, so EM iterations / chunks / bench reps all
    hit the jit cache."""

    def sweep(state, seg_block, epochs, mutation_rate, rho, lags,
              bias_heights=None, bias_strengths=None, delays=None, tblq=None,
              guide=None, vb_tables=None, rec_masks=None):
        if cfg.use_bias:
            bias_heights = jnp.asarray(bias_heights, jnp.float32)
            bias_strengths = jnp.asarray(bias_strengths, jnp.float32)
        if cfg.use_bias or cfg.use_guide:
            delays = jnp.asarray(delays, jnp.float32)
        if cfg.apf > 0:
            tblq = tuple(jnp.asarray(t, jnp.float32) for t in tblq)
        if cfg.use_guide:
            guide = tuple(jnp.asarray(g, jnp.float32) for g in guide)
        else:
            guide = None
        if cfg.use_vb:
            vb_tables = tuple(jnp.asarray(v, jnp.float32) for v in vb_tables)
        else:
            vb_tables = None
        if rec_masks is not None:
            rec_masks = tuple(jnp.asarray(m, jnp.float32) for m in rec_masks)
        return _sweep_jit(cfg, state, seg_block, epochs,
                          jnp.float32(mutation_rate), jnp.float32(rho),
                          jnp.asarray(lags, jnp.float32),
                          bias_heights, bias_strengths, delays, tblq, guide,
                          vb_tables, rec_masks)

    return sweep


def default_lags(epochs: Epochs, rho: float, lag_fraction: float = 0.0) -> np.ndarray:
    """Per-epoch lag defaults (count.cpp:230-247): 4 / (rho * top_t), where
    top_t is the epoch's upper boundary; 20 kb if only one epoch."""
    E = epochs.num_epochs
    start = np.asarray(epochs.start)
    if E == 1:
        return np.array([20000.0], dtype=np.float32)
    top = np.append(start[1:], start[-1])
    lags = 4.0 / (rho * np.maximum(top, 1e-30))
    return lags.astype(np.float32)
