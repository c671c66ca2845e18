"""Multi-chip execution: particle-axis data parallelism over a device mesh.

The reference's only parallelism is process-level genome chunking plus SGE
(SURVEY.md §2.4); here the particle population is sharded over chips
(`jax.sharding.NamedSharding` on axis ``'p'``) and the per-step collectives —
log-normalizer (logsumexp), ESS (Σw²), and the systematic-resampling
cumsum/searchsorted/ancestry-gather — are emitted by XLA's GSPMD partitioner
from the same single-program sweep code, riding the links between the
cards (NVLink on one host).  Genome chunks map to independent devices or
processes exactly like the reference's ``-chunks``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the particle axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=("p",))


def _spec_for(x, mesh: Mesh):
    """Shard any leading-particle-axis array over 'p'; replicate scalars and
    epoch-indexed vectors."""
    if x.ndim == 0:
        return NamedSharding(mesh, P())
    return NamedSharding(mesh, P("p", *([None] * (x.ndim - 1))))


def shard_pf_state(state, mesh: Mesh, num_particles: int):
    """Place a PFState so that every [P, ...] tensor is sharded over 'p' and
    everything else is replicated."""

    def place(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == num_particles:
            s = NamedSharding(mesh, P("p", *([None] * (x.ndim - 1))))
        else:
            s = NamedSharding(mesh, P())
        return jax.device_put(x, s)

    return jax.tree_util.tree_map(place, state)


def sharded_step(step_fn, mesh: Mesh, num_particles: int):
    """Jit a segment-scan step with particle-axis sharding constraints.

    GSPMD partitions the whole sweep: elementwise particle ops stay local,
    reductions become psums across the cards, and the resampling gather
    becomes a collective permute/all-gather.
    """

    def wrapped(state, block):
        return jax.lax.scan(step_fn, state, block)

    return jax.jit(wrapped)
