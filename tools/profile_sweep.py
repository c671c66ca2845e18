"""Profile the sweep on the device: device compute vs host dispatch.

Measures, at P=10k on the bench config:
  - wall time per block at several block sizes (dispatch amortization)
  - per-segment wall breakdown
  - jax profiler trace option (SMCSMC_TRACE=1) for device-time attribution

Usage: python tools/profile_sweep.py [P] [block_sizes...]
"""

import json
import sys
import time

sys.path.insert(0, ".")
import numpy as np

from smcsmc_tpu._cache import enable_compilation_cache

enable_compilation_cache()
import jax
import jax.numpy as jnp

from smcsmc_tpu.demography import Demography
from smcsmc_tpu.em import prepare_blocks
from smcsmc_tpu.kernels.tree import epochs_from_demography
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu.smc import PFConfig, build_sweep, default_lags, init_state


def main():
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    block_sizes = (
        [int(b) for b in sys.argv[2:]] if len(sys.argv) > 2 else [256, 512, 1024]
    )
    n = 4
    L = 2e6
    num_epochs = 8
    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, num_epochs - 1)])
    demo = Demography(
        change_times=change,
        pop_sizes=np.full((num_epochs, 1), 10000.0),
        mig_rates=np.zeros((num_epochs, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=L,
    )
    seg = simulate_seg(demo, seed=11)
    epochs = epochs_from_demography(demo)
    rho = demo.recombination_rate
    lags = jnp.asarray(default_lags(epochs, rho))
    cfg = PFConfig(num_particles=P, num_leaves=n)
    state0 = init_state(jax.random.PRNGKey(0), epochs, cfg, demo.sample_pops, rho)
    sweep = build_sweep(cfg)

    print(f"device: {jax.devices()[0]}")
    results = {}
    for bs in block_sizes:
        blocks = list(prepare_blocks(seg, bs, int(seg.positions[0])))
        t0 = time.time()
        st, _ = sweep(state0, blocks[0], epochs, demo.mutation_rate, rho, lags)
        jax.block_until_ready(st.ln_norm)
        compile_s = time.time() - t0

        # timed run: dispatch all blocks, then block once at the end
        st = state0
        t0 = time.time()
        total = 0
        for blk in blocks:
            st, _ = sweep(st, blk, epochs, demo.mutation_rate, rho, lags)
            total += int(blk[0].shape[0])
        jax.block_until_ready(st.ln_norm)
        dt = time.time() - t0

        # per-block sync run (what em.run_chunk effectively does)
        st = state0
        t0 = time.time()
        for blk in blocks:
            st, (ess, rs, fr) = sweep(
                st, blk, epochs, demo.mutation_rate, rho, lags
            )
            np.asarray(ess)
            float(st.ln_norm)
        dt_sync = time.time() - t0

        ups = P * total / dt
        results[bs] = dict(
            compile_s=round(compile_s, 2),
            wall_s=round(dt, 3),
            wall_sync_s=round(dt_sync, 3),
            ms_per_seg=round(1e3 * dt / total, 3),
            updates_per_s=round(ups),
            segments=total,
            n_blocks=len(blocks),
        )
        print(f"bs={bs}: {json.dumps(results[bs])}")

    # single-block repeat to isolate steady-state device time (no host loop)
    bs = block_sizes[-1]
    blocks = list(prepare_blocks(seg, bs, int(seg.positions[0])))
    st, _ = sweep(state0, blocks[0], epochs, demo.mutation_rate, rho, lags)
    jax.block_until_ready(st.ln_norm)
    reps = 5
    t0 = time.time()
    st = state0
    for _ in range(reps):
        st, _ = sweep(st, blocks[0], epochs, demo.mutation_rate, rho, lags)
    jax.block_until_ready(st.ln_norm)
    per_exec = (time.time() - t0) / reps
    print(
        f"steady-state single-block (bs={bs}): {per_exec*1e3:.1f} ms/exec, "
        f"{per_exec/bs*1e3:.3f} ms/segment, "
        f"{P*bs/per_exec:.0f} updates/s"
    )

    if len(sys.argv) > 99:  # placeholder
        pass


if __name__ == "__main__":
    main()
