"""Benchmark: particle-site updates/s/chip (BASELINE.json metric).

Headline: the particle-filter sweep on simulated single-population data at
P=10k; throughput = num_particles * segments_processed / wall_clock.  The
timed loop runs twice and the best is reported.

North-star configs run after the headline, each in its own subprocess, and
land under ``detail.configs``:

- ``twopop_em_iter``: the BASELINE.json 2-pop 4-haplotype config — wall
  clock per EM iteration (E-step sweep + M-step, steady state) with
  migration inference on.
- ``feature_bias_guide``, ``feature_vb``, ``feature_apf``: feature-on
  sweeps at P=10k (bias+guide / variational-Bayes / auxiliary PF).
- ``p50k``: single-population P=50000, the reference's recommended
  real-analysis scale (docs/source/getting_started.rst).

The headline runs at the requested P or fails: it never falls back to a
smaller population.

Baselines (BASELINE.md: the reference publishes no numbers, so every anchor
must be derived and labeled):

1. ``vs_baseline`` keeps the round-2 convention: the generous reference
   C++ proxy of 1e5 updates/s/core.  Derivation: the reference CI runs
   1e7 bp at Np=1000 within 1300 s on one core
   (test_const_pop_size.py:17-32, run_tests.sh:4); at theta = 4*1e4*1e-8
   that is ~4.6e3 segregating sites, giving a *demonstrated floor* of
   1000 * 4600 / 1300 ~= 3.5e3 updates/s/core; the proxy multiplies the
   floor by ~30 assuming the CI test passes well inside its bound.
2. ``cpu_updates_per_sec`` is MEASURED (not asserted): this framework's own
   sweep, identical model/data, run on ONE pinned CPU core at Np=1000 (the
   reference's CI particle count).  ``vs_cpu_1core`` is the
   accelerator-vs-CPU-core ratio for this exact workload.
3. ``reference_floor_updates_per_sec`` = 3.5e3, the hard floor from (1);
   ``vs_reference_floor`` reports against it.
"""

import json
import os
import subprocess
import sys

BASELINE_UPDATES_PER_SEC = 1.0e5  # generous C++ single-core proxy (see above)
REFERENCE_FLOOR_UPDATES_PER_SEC = 3.5e3  # demonstrated CI floor (see above)
_HERE = os.path.dirname(os.path.abspath(__file__))

_PRELUDE = f"""
import json, sys, time
sys.path.insert(0, {_HERE!r})
import numpy as np
from smcsmc_tpu._cache import enable_compilation_cache
enable_compilation_cache()
import jax, jax.numpy as jnp
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.em import EMConfig, m_step, prepare_blocks, prior_pseudostats, run_chunk
from smcsmc_tpu.kernels.tree import epochs_from_demography
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu.smc import PFConfig, build_sweep, default_lags, init_state

def single_pop_demo(n=4, L=2e6, num_epochs=8):
    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, num_epochs - 1)])
    return Demography(
        change_times=change,
        pop_sizes=np.full((num_epochs, 1), 10000.0),
        mig_rates=np.zeros((num_epochs, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=L,
    )

def twopop_demo(L=2e6, num_epochs=8, m=5e-5):
    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, num_epochs - 1)])
    mig = np.zeros((num_epochs, 2, 2))
    mig[:, 0, 1] = m
    mig[:, 1, 0] = m
    return Demography(
        change_times=change,
        pop_sizes=np.full((num_epochs, 2), 10000.0),
        mig_rates=mig,
        sample_pops=np.array([0, 0, 1, 1], dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=L,
    )

def count_segments(demo, seg):
    from smcsmc_tpu.segio import split_long_segments
    max_seg_len = 2.0 / max(4.0 * demo.n0 * demo.recombination_rate, 1e-30)
    return split_long_segments(seg, max_seg_len).num_segments
"""


def _run_sub(code: str, tag: str, timeout: int = 600) -> dict | None:
    """Run bench code in a fresh subprocess; parse the '<tag> {json}' line."""
    try:
        out = subprocess.run(
            [sys.executable, "-c", _PRELUDE + code],
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        print(f"# bench {tag} timed out", file=sys.stderr)
        return None
    for line in out.stdout.splitlines():
        if line.startswith(tag + " "):
            return json.loads(line[len(tag) + 1:])
    tail = (out.stderr or "")[-500:]
    print(f"# bench {tag} failed rc={out.returncode}: {tail!r}", file=sys.stderr)
    return None


def run_attempt(P: int) -> dict | None:
    """Headline sweep at P particles; best of two timed loops."""
    code = f"""
P = {P}
demo = single_pop_demo()
seg = simulate_seg(demo, seed=11)
epochs = epochs_from_demography(demo)
rho = demo.recombination_rate
lags = jnp.asarray(default_lags(epochs, rho))
cfg = PFConfig(num_particles=P, num_leaves=4)
state = init_state(jax.random.PRNGKey(0), epochs, cfg, demo.sample_pops, rho)
sweep = build_sweep(cfg)
def run(st, blk):
    return sweep(st, blk, epochs, demo.mutation_rate, rho, lags)
blocks = list(prepare_blocks(seg, 256, int(seg.positions[0])))
st, _ = run(state, blocks[0])  # warmup/compile
jax.block_until_ready(st.ln_norm)
best, ln = None, None
for rep in range(2):
    t0 = time.time()
    total_segments = 0
    st = state
    for blk in blocks:
        st, _ = run(st, blk)
        total_segments += int(blk[0].shape[0])
    jax.block_until_ready(st.ln_norm)
    dt = time.time() - t0
    ln = float(st.ln_norm)
    if best is None or dt < best:
        best = dt
print("BENCH_RESULT " + json.dumps({{
    "segments": total_segments, "wall_clock_s": best,
    "ln_norm": ln, "device": str(jax.devices()[0]),
}}))
"""
    return _run_sub(code, "BENCH_RESULT", timeout=3000)


def run_cpu_anchor(P: int = 1000, max_blocks: int = 2) -> dict | None:
    """Measure this framework's own sweep on ONE pinned CPU core (a
    measured, falsifiable baseline).  Np=1000 matches the
    reference's CI config (test_const_pop_size.py:17-32)."""
    code = f"""
import json, os, sys, time
os.environ["JAX_PLATFORMS"] = "cpu"
try:
    os.sched_setaffinity(0, {{0}})
except (AttributeError, OSError):
    pass
sys.path.insert(0, {_HERE!r})
import numpy as np
import jax, jax.numpy as jnp
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.em import prepare_blocks
from smcsmc_tpu.kernels.tree import epochs_from_demography
from smcsmc_tpu.simulate import simulate_seg
from smcsmc_tpu.smc import PFConfig, build_sweep, default_lags, init_state

P = {P}
n = 4
num_epochs = 8
change = np.concatenate([[0.0], np.logspace(2.5, 5.0, num_epochs - 1)])
demo = Demography(
    change_times=change,
    pop_sizes=np.full((num_epochs, 1), 10000.0),
    mig_rates=np.zeros((num_epochs, 1, 1)),
    sample_pops=np.zeros(n, dtype=np.int32),
    mutation_rate=1e-8,
    recombination_rate=1e-9,
    sequence_length=2e6,
)
seg = simulate_seg(demo, seed=11)
epochs = epochs_from_demography(demo)
rho = demo.recombination_rate
lags = jnp.asarray(default_lags(epochs, rho))
cfg = PFConfig(num_particles=P, num_leaves=n)
state = init_state(jax.random.PRNGKey(0), epochs, cfg, demo.sample_pops, rho)
sweep = build_sweep(cfg)
def run(st, blk):
    return sweep(st, blk, epochs, demo.mutation_rate, rho, lags)
blocks = list(prepare_blocks(seg, 256, int(seg.positions[0])))[: {max_blocks}]
st, _ = run(state, blocks[0])  # warmup/compile
jax.block_until_ready(st.ln_norm)
t0 = time.time()
total_segments = 0
st = state
for blk in blocks:
    st, _ = run(st, blk)
    total_segments += int(blk[0].shape[0])
jax.block_until_ready(st.ln_norm)
dt = time.time() - t0
print("CPU_RESULT " + json.dumps({{
    "segments": total_segments, "wall_clock_s": dt, "num_particles": P,
}}))
"""
    try:
        out = subprocess.run(
            [sys.executable, "-c", code],
            capture_output=True,
            text=True,
            timeout=1200,
            env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": _HERE},
        )
    except subprocess.TimeoutExpired:
        print("# cpu anchor timed out", file=sys.stderr)
        return None
    for line in out.stdout.splitlines():
        if line.startswith("CPU_RESULT "):
            return json.loads(line[len("CPU_RESULT "):])
    print(f"# cpu anchor failed: {(out.stderr or '')[-300:]!r}", file=sys.stderr)
    return None


def run_twopop_em(P: int = 10000, timeout: int = 2400) -> dict | None:
    """Wall-clock per EM iteration on the 2-pop 4-haplotype config (the
    BASELINE.json north-star).  Iteration 1 compiles; iteration 2 is timed
    (parameters are traced inputs, so the M-step-updated model reuses the
    compiled sweep — the steady state of a real multi-iteration run)."""
    code = f"""
P = {P}
demo = twopop_demo()
seg = simulate_seg(demo, seed=13)
segments = count_segments(demo, seg)
cfg = EMConfig(num_particles=P, block_size=2048)
stats, _, logl, _ = run_chunk(demo, seg, cfg, seed=3)  # compile + E-step
cur = m_step(demo, stats, cfg)
t0 = time.time()
stats, _, logl, _ = run_chunk(cur, seg, cfg, seed=4)
cur = m_step(cur, stats, cfg)
dt = time.time() - t0
print("TWOPOP_RESULT " + json.dumps({{
    "segments": segments, "wall_clock_s": dt, "num_particles": P,
    "logl": float(logl), "updates_per_s": P * segments / dt,
}}))
"""
    return _run_sub(code, "TWOPOP_RESULT", timeout=timeout)


def run_feature(name: str, P: int = 10000, timeout: int = 2400) -> dict | None:
    """Feature-on sweep throughput at P particles (steady state: second
    run_chunk call on the already-compiled program)."""
    if name == "bias_guide":
        setup = f"""
import gzip, tempfile
demo = single_pop_demo()
seg = simulate_seg(demo, seed=11)
# synthetic constant guide (rate = rho, per-leaf rel 1): exercises the full
# guided position/point sampling + delayed-IW machinery at its real cost
gpath = tempfile.mktemp(suffix=".recomb_guide.gz")
ws, L = 10000, int(demo.sequence_length)
with gzip.open(gpath, "wt") as fh:
    fh.write("locus\\tsize\\trecomb_rate\\t" +
             "\\t".join(str(i + 1) for i in range(4)) + "\\n")
    for w in range(0, L + ws, ws):
        fh.write(f"{{w}}\\t{{ws}}\\t{{demo.recombination_rate:.4e}}\\t" +
                 "\\t".join("1.0" for _ in range(4)) + "\\n")
cfg = EMConfig(num_particles={P}, block_size=2048,
               bias_heights=(400.0,), bias_strengths=(2.0, 1.0))
kw = dict(guide_file=gpath)
"""
    elif name == "vb":
        setup = f"""
demo = single_pop_demo()
seg = simulate_seg(demo, seed=11)
cfg = EMConfig(num_particles={P}, block_size=2048, vb=True)
kw = {{}}
"""
    elif name == "apf":
        setup = f"""
demo = single_pop_demo()
seg = simulate_seg(demo, seed=11)
cfg = EMConfig(num_particles={P}, block_size=2048, apf=2)
kw = {{}}
"""
    elif name == "apf8":
        # BASELINE.json config 4: 8 haplotypes, 10k particles, lookahead
        # weighting, variable data (missing windows + unphased pairs)
        setup = f"""
from smcsmc_tpu.segio import SegData
demo = single_pop_demo(n=8)
seg = simulate_seg(demo, seed=11)
al = seg.alleles.copy()
al[(seg.positions // 100_000) % 4 == 1] = -1          # missing windows
het = (al[:, 0] + al[:, 1] == 1) & (al[:, 0] >= 0)
al[het, 0] = 2
al[het, 1] = 2                                        # unphased pair 0/1
seg = SegData(positions=seg.positions, lengths=seg.lengths,
              states=seg.states, alleles=al,
              phased=np.array([False, False] + [True] * 6))
cfg = EMConfig(num_particles={P}, block_size=2048, apf=2, apf_trees=50000)
kw = {{}}
"""
    elif name == "p50k":
        setup = f"""
demo = single_pop_demo()
seg = simulate_seg(demo, seed=11)
cfg = EMConfig(num_particles={P}, block_size=2048)
kw = {{}}
"""
    else:
        raise ValueError(name)
    code = setup + f"""
segments = count_segments(demo, seg)
run_chunk(demo, seg, cfg, seed=3, **kw)  # compile
t0 = time.time()
_, _, logl, _ = run_chunk(demo, seg, cfg, seed=4, **kw)
dt = time.time() - t0
print("FEATURE_RESULT " + json.dumps({{
    "segments": segments, "wall_clock_s": dt, "num_particles": {P},
    "logl": float(logl), "updates_per_s": {P} * segments / dt,
}}))
"""
    return _run_sub(code, "FEATURE_RESULT", timeout=timeout)


def main():
    """Emit incrementally under a total time budget: the headline JSON line
    prints (flushed) as soon as the headline sweep + CPU anchor finish, so a driver that kills the run mid-configs still
    records a number.  Each completed config re-prints the FULL updated JSON
    as a new line (drivers that take the last parseable line get the most
    complete result; drivers that take the first get the headline).  The
    running result is also mirrored to BENCH_local.json after every stage.

    ``SMCSMC_BENCH_BUDGET_S`` (default 1500 s) bounds the whole run: configs
    that would start past the budget are skipped with a marker instead of
    losing the output."""
    import time as _time

    t_start = _time.monotonic()
    budget = float(os.environ.get("SMCSMC_BENCH_BUDGET_S", "1500"))
    P = int(sys.argv[1]) if len(sys.argv) > 1 else 10000
    quick = os.environ.get("SMCSMC_BENCH_QUICK")
    res = run_attempt(P)
    if res is None:
        raise SystemExit(f"headline bench failed at P={P}")

    updates_per_sec = P * res["segments"] / res["wall_clock_s"]

    cpu = run_cpu_anchor()
    cpu_ups = (
        cpu["num_particles"] * cpu["segments"] / cpu["wall_clock_s"]
        if cpu
        else None
    )

    configs = {}
    result = {
        "metric": "particle_site_updates_per_sec_per_chip",
        "value": float(updates_per_sec),
        "unit": "particle-site updates/s",
        "vs_baseline": float(updates_per_sec / BASELINE_UPDATES_PER_SEC),
        "detail": {
            "num_particles": P,
            "segments": res["segments"],
            "wall_clock_s": res["wall_clock_s"],
            "n_haplotypes": 4,
            "epochs": 8,
            "sequence_bp": 2e6,
            "device": res["device"],
            "baseline_proxy_updates_per_sec": BASELINE_UPDATES_PER_SEC,
            "cpu_updates_per_sec": cpu_ups,
            "cpu_anchor": cpu,
            "vs_cpu_1core": (
                float(updates_per_sec / cpu_ups) if cpu_ups else None
            ),
            "reference_floor_updates_per_sec": REFERENCE_FLOOR_UPDATES_PER_SEC,
            "vs_reference_floor": float(
                updates_per_sec / REFERENCE_FLOOR_UPDATES_PER_SEC
            ),
            "configs": configs,
        },
    }

    def emit():
        print(json.dumps(result), flush=True)
        try:
            with open(os.path.join(_HERE, "BENCH_local.json"), "w") as fh:
                json.dump(result, fh)
        except OSError:
            pass

    emit()  # headline recorded NOW — configs only ever add to it

    def remaining():
        return budget - (_time.monotonic() - t_start)

    if not quick:
        stages = [("twopop_em_iter", lambda t: run_twopop_em(P, timeout=t))]
        stages += [
            (f"feature_{feat}",
             lambda t, f=feat: run_feature(f, P, timeout=t))
            for feat in ["bias_guide", "vb", "apf", "apf8"]
        ]
        stages.append(("p50k", lambda t: run_feature("p50k", 50000, timeout=t)))
        for name, fn in stages:
            left = remaining()
            if left < 60:
                configs[name] = {"skipped": f"budget exhausted ({left:.0f}s left)"}
                continue
            configs[name] = fn(int(min(left, 2400)))
            emit()

    emit()


if __name__ == "__main__":
    main()
