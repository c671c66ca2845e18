"""Kernels and time per recombination trip of the sweep, from one
``jax.profiler`` trace on the card.

    python tools/trace_trip.py        # writes chiprun_out/trace/summary.json

The headline sweep configuration (n=4, 8 epochs, P=10,000; ``TRACE_P``
overrides P) runs twice on 8 synthetic segments with the trip count forced
to 4 and to 36 per segment (``PFConfig.max_recomb_iters``); the difference
of the two traces over the 256 extra trips gives kernels, memcpys, kernel
time, device-busy time and wall time per trip, and the gaps' share of a
trip.  Then 2 blocks x 256 segments of simulated data give ms per segment,
kernels per segment and the device idle share of the traced window.  Each
timed call runs once to compile, three times for the best wall time, and
once under the profiler.  Device events are read from
the trace's GPU planes (``Stream`` lines).
"""
import glob
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.profiler import ProfileData  # noqa: E402

import chip_smoke as cs  # noqa: E402
from smcsmc_tpu.em import prepare_blocks  # noqa: E402
from smcsmc_tpu.kernels.tree import epochs_from_demography  # noqa: E402
from smcsmc_tpu.segio import SegData  # noqa: E402
from smcsmc_tpu.simulate import simulate_seg  # noqa: E402
from smcsmc_tpu.smc import PFConfig, build_sweep, default_lags, init_state  # noqa: E402

OUT = os.path.join("chiprun_out", "trace")
os.makedirs(OUT, exist_ok=True)
P, n = int(os.environ.get("TRACE_P", 10000)), 4
demo = cs.single_pop_demo(n=n, L=2e6)
epochs = epochs_from_demography(demo)
lags = default_lags(epochs, cs.RHO)
dump_lines = True


def summarize(tdir):
    global dump_lines
    path = glob.glob(os.path.join(tdir, "**", "*.xplane.pb"), recursive=True)[0]
    d = ProfileData.from_file(path)
    out = dict(kernels=0, kernel_ns=0, memcpy=0, memcpy_ns=0, busy_ns=0,
               span_ns=0, names={})
    ivs = []
    for pl in d.planes:
        if "GPU" not in pl.name and "gpu" not in pl.name:
            continue
        for ln in pl.lines:
            evs = [(e.name, e.start_ns, e.duration_ns) for e in ln.events]
            if dump_lines:
                print("LINE", pl.name, "|", ln.name, len(evs),
                      [e[0][:60] for e in evs[:3]], flush=True)
            if not ln.name.startswith("Stream"):
                continue
            for name, s, dur in evs:
                ivs.append((s, s + dur))
                if "emcpy" in name or "MEMCPY" in name:
                    out["memcpy"] += 1
                    out["memcpy_ns"] += dur
                else:
                    out["kernels"] += 1
                    out["kernel_ns"] += dur
                    out["names"][name] = out["names"].get(name, 0) + 1
    dump_lines = False
    ivs.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        out["span_ns"] = ivs[-1][1] - ivs[0][0]
    out["busy_ns"] = busy
    top = sorted(out["names"].items(), key=lambda kv: -kv[1])[:12]
    out["names"] = top
    return out


def run_traced(tag, fn):
    fn()  # warm (compile)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    tdir = os.path.join(OUT, tag)
    jax.profiler.start_trace(tdir)
    t0 = time.perf_counter()
    fn()
    traced_wall = time.perf_counter() - t0
    jax.profiler.stop_trace()
    s = summarize(tdir)
    shutil.rmtree(tdir, ignore_errors=True)
    s.update(wall_s=min(walls), walls=walls, traced_wall_s=traced_wall)
    return s


def forced(T, S=8):
    cfg = PFConfig(num_particles=P, num_leaves=n, max_recomb_iters=T)
    rng = np.random.default_rng(0)
    seg = SegData(
        positions=np.arange(S, dtype=np.int64) * 2_000_000,
        lengths=np.full(S, 2_000_000, np.int64),
        states=np.zeros(S, np.int8),
        alleles=rng.integers(0, 2, (S, n)).astype(np.int8),
        phased=np.ones(n, bool),
    )
    (block,) = list(prepare_blocks(seg, S, 0))
    state0 = init_state(jax.random.PRNGKey(0), epochs, cfg, demo.sample_pops,
                        cs.RHO)
    sweep = build_sweep(cfg)

    def fn():
        st, _ = sweep(state0, block, epochs, cs.MU, cs.RHO, lags)
        jax.block_until_ready(st.ln_norm)

    return run_traced(f"forced{T}", fn)


def headline(block_size=256, nblocks=2):
    cfg = PFConfig(num_particles=P, num_leaves=n)
    seg = simulate_seg(demo, seed=11)
    blocks = list(prepare_blocks(seg, block_size, int(seg.positions[0])))
    state0 = init_state(jax.random.PRNGKey(0), epochs, cfg, demo.sample_pops,
                        cs.RHO)
    sweep = build_sweep(cfg)

    def fn():
        st = state0
        for b in blocks[:nblocks]:
            st, _ = sweep(st, b, epochs, cs.MU, cs.RHO, lags)
        jax.block_until_ready(st.ln_norm)

    s = run_traced("headline", fn)
    s["segments"] = block_size * nblocks
    return s


res = {"card": cs.card_line() if jax.default_backend() == "gpu" else "cpu",
       "device_kind": jax.devices()[0].device_kind, "P": P}
lo, hi, S = 4, 36, 8
res["forced_lo"] = forced(lo, S)
res["forced_hi"] = forced(hi, S)
dT = (hi - lo) * S
a, b = res["forced_lo"], res["forced_hi"]
res["per_trip"] = dict(
    kernels=(b["kernels"] - a["kernels"]) / dT,
    memcpy=(b["memcpy"] - a["memcpy"]) / dT,
    wall_us=(b["wall_s"] - a["wall_s"]) / dT * 1e6,
    kernel_us=(b["kernel_ns"] - a["kernel_ns"]) / dT / 1e3,
    busy_us=(b["busy_ns"] - a["busy_ns"]) / dT / 1e3,
)
res["per_trip"]["gap_share"] = 1 - res["per_trip"]["busy_us"] / res["per_trip"]["wall_us"]
h = res["headline"] = headline()
h["ms_per_segment"] = h["wall_s"] / h["segments"] * 1e3
h["idle_share_traced"] = 1 - h["busy_ns"] / 1e9 / h["traced_wall_s"]
h["kernels_per_segment"] = h["kernels"] / h["segments"]
with open(os.path.join(OUT, "summary.json"), "w") as fh:
    json.dump(res, fh, indent=1, default=float)
print("TRACE_SUMMARY", json.dumps(res, default=float))
