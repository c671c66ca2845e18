"""Multi-host (multi-process) chunk parallelism.

The reference scales across machines by launching one ``smcsmc`` process per
genome chunk through SGE and summing the per-chunk sufficient statistics
from ``.out`` files (/root/reference/smcsmc/execute.py:26-105,
model.py:903-910, 1094-1100).  The equivalent here (SURVEY.md §2.4,
§5.8): each *process* (host group) runs its own chunk sweep on its local
devices, and the O(epochs × pops²) sufficient-statistic tensors plus the
scalar log-likelihoods are reduced across processes with one
all-reduce per EM iteration — the only cross-host communication the
algorithm needs.

Usage (one process per host / per chunk group):

    from smcsmc_tpu.parallel import distributed as dist
    dist.initialize(coordinator, num_processes, process_id)
    stats, stats_wt, logl, diag = run_chunk(demo, seg, cfg,
                                            chunk=my_chunks[process_id], ...)
    stats = dist.allreduce_stats(stats)  # allgather + f64 host sum
    logl = dist.allreduce_scalar(logl)

Tested by tests/test_multihost.py with two coordinated CPU processes.
"""

from __future__ import annotations

import jax
import numpy as np


def initialize(
    coordinator_address: str, num_processes: int, process_id: int
) -> None:
    """Join the jax.distributed runtime (cross-process coordination).

    Mirrors ``jax.distributed.initialize``; call before any jax device use.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_initialized() -> bool:
    return jax.process_count() > 1


def allreduce_array(x: np.ndarray) -> np.ndarray:
    """Sum a host array across processes.

    Implementation: ``multihost_utils.process_allgather`` (the gather rides
    the network between hosts) followed by a host-side ``np.sum`` — NOT a
    device-side psum.  That is the right trade here: the reduced tensors
    are O(epochs × pops²) floats moved once per EM iteration, and the f64
    host sum avoids f32 accumulation error on the statistics; a shard_map
    psum would save nothing measurable while forcing the tensors through
    device dtypes."""
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return np.asarray(x)
    # process_allgather stacks each process's local value along axis 0
    gathered = multihost_utils.process_allgather(np.asarray(x))
    return np.sum(gathered, axis=0)


def allreduce_stats(stats):
    """Cross-process sum of a SuffStats pytree (model.py:903-910 semantics:
    Opp/Count tensors add across chunks)."""
    return jax.tree_util.tree_map(lambda a: allreduce_array(a), stats)


def allreduce_scalar(x: float) -> float:
    return float(allreduce_array(np.asarray(x, dtype=np.float64)))
