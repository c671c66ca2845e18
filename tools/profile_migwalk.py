"""Profile the 2-pop continuous-migration sweep: jump walk vs loop walk.

The lock-step event walk is latency-bound on the population-max event
count.  This measures both implementations on the same config and prints
ms/segment + particle-site updates/s.

Usage: python tools/profile_migwalk.py [P] [impl ...]
       impl defaults to both: jump loop
"""

import os
import sys
import time

sys.path.insert(0, ".")


def measure(impl: str, P: int, n_blocks: int = 4, bs: int = 256) -> dict:
    os.environ["SMCSMC_MIG_WALK"] = impl
    from smcsmc_tpu._cache import enable_compilation_cache

    enable_compilation_cache()
    import numpy as np
    import jax
    import jax.numpy as jnp

    from smcsmc_tpu.demography import Demography
    from smcsmc_tpu.em import prepare_blocks
    from smcsmc_tpu.kernels.tree import epochs_from_demography
    from smcsmc_tpu.simulate import simulate_seg
    from smcsmc_tpu.smc import PFConfig, build_sweep, default_lags, init_state

    num_epochs, m = 8, 5e-5
    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, num_epochs - 1)])
    mig = np.zeros((num_epochs, 2, 2))
    mig[:, 0, 1] = m
    mig[:, 1, 0] = m
    demo = Demography(
        change_times=change,
        pop_sizes=np.full((num_epochs, 2), 10000.0),
        mig_rates=mig,
        sample_pops=np.array([0, 0, 1, 1], dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=4e6,
    )
    seg = simulate_seg(demo, seed=13)
    epochs = epochs_from_demography(demo)
    rho = demo.recombination_rate
    lags = jnp.asarray(default_lags(epochs, rho))
    from smcsmc_tpu.em import _auto_mig_sizes

    mj, mk = _auto_mig_sizes(demo)
    cfg = PFConfig(num_particles=P, num_leaves=4, has_migration=True,
                   max_mig=56, mig_jumps=mj, mig_compact=mk,
                   mig_uniform=os.environ.get("MIGW_UNIFORM", "1") == "1")
    state = init_state(jax.random.PRNGKey(0), epochs, cfg, demo.sample_pops,
                       rho)
    sweep = build_sweep(cfg)
    blocks = list(prepare_blocks(seg, bs, int(seg.positions[0])))[:n_blocks]

    t0 = time.time()
    st, _ = sweep(state, blocks[0], epochs, demo.mutation_rate, rho, lags)
    jax.block_until_ready(st.ln_norm)
    compile_s = time.time() - t0

    best = None
    for _ in range(2):
        st = state
        t0 = time.time()
        nseg = 0
        for blk in blocks:
            st, _ = sweep(st, blk, epochs, demo.mutation_rate, rho, lags)
            nseg += int(blk[0].shape[0])
        jax.block_until_ready(st.ln_norm)
        dt = time.time() - t0
        if best is None or dt < best:
            best = dt
    return {
        "impl": impl,
        "P": P,
        "segments": nseg,
        "compile_s": round(compile_s, 1),
        "ms_per_segment": round(1e3 * best / nseg, 3),
        "updates_per_s": round(P * nseg / best),
        "ln_norm": float(st.ln_norm),
    }


def main():
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    impls = sys.argv[2:] or ["jump", "loop"]
    for impl in impls:
        # fresh process per impl so the env switch is honored at trace time
        if os.environ.get("_MIGWALK_CHILD") == impl:
            print(measure(impl, P))
            return
        import subprocess

        env = dict(os.environ, _MIGWALK_CHILD=impl)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), str(P), impl],
            env=env, capture_output=True, text=True, timeout=3600,
        )
        out = r.stdout.strip().splitlines()
        print(out[-1] if out else f"FAILED: {r.stderr[-300:]}")


if __name__ == "__main__":
    main()
