"""End-to-end proof that the smc2 engine runs on an NVIDIA GPU.

    python chip_smoke.py              # one card: phases 1-6 below
    python chip_smoke.py --chips 4    # four cards: chunk workers and the
                                      # particle-sharded sweep, nothing else

Phases on one card, all in this one process (a JAX process reserves most of
the card's memory, so a second one could not start):

1. device: JAX's devices, and the card's name and power limit;
2. ``smc2`` end to end through ``cli.smcsmc_main`` at P=10,000: simulated
   single-population data (4 haplotypes, 5 Mb), 8 epochs, two EM
   iterations; Ne and the recombination rate within 2x of the truth;
3. two-population migration sweep (``em.run_chunk``, P=10,000,
   block_size=2048): migration rate within 2x of the truth;
4. feature paths at P=10,000: APF with the native lookahead on 8 unphased
   haplotypes with missing windows, and 16 haplotypes (the likelihood's
   ``while_loop`` path);
5. the site likelihood on 10,000 random trees (n=4 and n=16) against a
   float64 numpy pruning;
6. the device test tier (``tests/test_gpu_smoke.py`` and the statistical
   gates of ``tests/test_gpu_stat_gates.py``), through ``pytest.main``.
   The gates in ``OPEN_GATES`` fail on an H100 for causes measured there
   and queued in ROADMAP.md; their outcome is reported, and any other
   failure fails the run.

Timings print with the card's name and power limit.  Any failed check
fails the run; the last line of a run that passed is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
With no GPU, or outside a checkout of this repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NE, MU, RHO = 10000.0, 1e-8, 1e-9
MIG = 5e-5


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    """The cards' name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    lines = [ln.strip() for ln in out.stdout.splitlines()]
    return "; ".join(ln for ln in lines if ln)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def single_pop_demo(n=4, L=5e6, num_epochs=8):
    import numpy as np

    from smcsmc_tpu.demography import Demography

    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, num_epochs - 1)])
    return Demography(
        change_times=change,
        pop_sizes=np.full((num_epochs, 1), NE),
        mig_rates=np.zeros((num_epochs, 1, 1)),
        sample_pops=np.zeros(n, dtype=np.int32),
        mutation_rate=MU,
        recombination_rate=RHO,
        sequence_length=L,
    )


def twopop_demo(L=2e6, num_epochs=8, m=MIG):
    """Symmetric island model, 2 haplotypes per population."""
    import numpy as np

    from smcsmc_tpu.demography import Demography

    change = np.concatenate([[0.0], np.logspace(2.5, 5.0, num_epochs - 1)])
    mig = np.zeros((num_epochs, 2, 2))
    mig[:, 0, 1] = m
    mig[:, 1, 0] = m
    return Demography(
        change_times=change,
        pop_sizes=np.full((num_epochs, 2), NE),
        mig_rates=mig,
        sample_pops=np.array([0, 0, 1, 1], dtype=np.int32),
        mutation_rate=MU,
        recombination_rate=RHO,
        sequence_length=L,
    )


def unphased_missing(seg):
    """Missing windows (every 4th 100 kb) and an unphased pair 0/1."""
    import numpy as np

    from smcsmc_tpu.segio import SegData

    al = seg.alleles.copy()
    al[(seg.positions // 100_000) % 4 == 1] = -1
    het = (al[:, 0] + al[:, 1] == 1) & (al[:, 0] >= 0)
    al[het, 0] = 2
    al[het, 1] = 2
    n = al.shape[1]
    return SegData(positions=seg.positions, lengths=seg.lengths,
                   states=seg.states, alleles=al,
                   phased=np.array([False, False] + [True] * (n - 2)))


def pooled_ne(stats) -> float:
    return float(stats.coal_opp.sum() / (2.0 * stats.coal_cnt.sum()))


def within(x: float, truth: float, factor: float = 2.0) -> bool:
    return truth / factor < x < truth * factor


class ChunkRecorder:
    """Wraps ``em.run_chunk`` (which ``run_em``/``run_chunks`` call) to record
    each chunk sweep's wall time, result and device."""

    def __init__(self):
        from smcsmc_tpu import em

        self.em = em
        self.calls = []

    def __enter__(self):
        inner = self.orig = self.em.run_chunk

        def recorded(demo, seg, cfg, *a, **kw):
            t0 = time.perf_counter()
            out = inner(demo, seg, cfg, *a, **kw)
            self.calls.append(dict(
                seconds=time.perf_counter() - t0, chunk=kw.get("chunk"),
                particles=cfg.num_particles, stats=out[0], logl=out[2],
                segments=out[3]["segments"], device=out[3]["device"],
            ))
            return out

        self.em.run_chunk = recorded
        return self

    def __exit__(self, *exc):
        self.em.run_chunk = self.orig


def read_out(path: str) -> list[dict]:
    """Rows of a result.out table as dicts of floats."""
    with open(path) as fh:
        header = fh.readline().split()
        rows = []
        for line in fh:
            vals = line.split()
            row = dict(zip(header, vals))
            rows.append({k: (v if k == "Type" else float(v))
                         for k, v in row.items()})
    return rows


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_smc2(workdir: str, card: str, P=10000, L=5e6, em_iters=2) -> dict:
    """``smc2`` through its CLI entry point on simulated data."""
    import numpy as np

    from smcsmc_tpu import cli
    from smcsmc_tpu.segio import write_seg
    from smcsmc_tpu.simulate import simulate_seg

    seg_path = os.path.join(workdir, "smc2.seg")
    out_dir = os.path.join(workdir, "smc2_out")
    write_seg(seg_path, simulate_seg(single_pop_demo(n=4, L=L), seed=42))
    # a finished run in the same directory would be resumed, not rerun
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["-seg", seg_path, "-o", out_dir, "-Np", str(P),
            "-EM", str(em_iters), "-N0", "10000", "-mu", "1e-8",
            "-rho", "1e-9", "-P", "133", "133016", "7*1", "-seed", "7"]
    t0 = time.perf_counter()
    with ChunkRecorder() as rec:
        check(cli.smcsmc_main(argv) == 0, "smc2 returned non-zero")
    total = time.perf_counter() - t0
    rows = read_out(os.path.join(out_dir, "result.out"))
    iters = sorted({int(r["Iter"]) for r in rows})
    check(iters == list(range(em_iters + 1)),
          f"result.out iteration blocks {iters}")
    for it in iters:
        logl = [r["Count"] for r in rows
                if r["Type"] == "LogL" and r["Iter"] == it]
        check(len(logl) == 1 and np.isfinite(logl[0]) and logl[0] < 0,
              f"iteration {it} LogL {logl}")
    last = [r for r in rows if r["Iter"] == em_iters]
    coal = [r for r in last if r["Type"] == "Coal"]
    ne = sum(r["Opp"] for r in coal) / (2.0 * sum(r["Count"] for r in coal))
    rec_rate = [r["Rate"] for r in last if r["Type"] == "Recomb"][0]
    check(within(ne, NE), f"pooled Ne {ne}")
    check(within(rec_rate, RHO), f"recombination rate {rec_rate}")
    secs = [c["seconds"] for c in rec.calls]
    warm = min(secs[1:])
    segs = rec.calls[-1]["segments"]
    return dict(
        iterations=len(secs), cold_s=secs[0], warm_s=warm,
        cold_minus_warm_s=secs[0] - warm, total_s=total, segments=segs,
        updates_per_s=P * segs / warm, pooled_ne=ne, recomb_rate=rec_rate,
        logl=[r["Count"] for r in rows if r["Type"] == "LogL"], card=card,
    )


def _one_chunk(demo, seg, cfg, seed):
    from smcsmc_tpu.em import run_chunk

    t0 = time.perf_counter()
    stats, _, logl, diag = run_chunk(demo, seg, cfg, seed=seed)
    return stats, logl, diag, time.perf_counter() - t0


def phase_migration(card: str, P=10000, L=2e6, block=2048) -> dict:
    """Two-population sweep at P=10,000 x block 2048, uncapped."""
    import numpy as np

    from smcsmc_tpu.em import EMConfig
    from smcsmc_tpu.simulate import simulate_seg

    demo = twopop_demo(L=L)
    seg = simulate_seg(demo, seed=13)
    cfg = EMConfig(num_particles=P, block_size=block)
    stats, logl, diag, secs = _one_chunk(demo, seg, cfg, seed=3)
    m = float(stats.mig_cnt.sum() / stats.mig_opp.sum())
    check(np.isfinite(logl) and logl < 0, f"migration LogL {logl}")
    check(within(m, MIG), f"migration rate {m}")
    return dict(seconds=secs, block_size=block, logl=logl, mig_rate=m,
                segments=diag["segments"],
                updates_per_s=P * diag["segments"] / secs,
                walks_capped=diag["walks_capped"],
                mig_events_dropped=diag["mig_events_dropped"], card=card)


def phase_features(card: str, P=10000, L=2e6, block=2048,
                   apf_trees=50000) -> dict:
    """APF + native lookahead on unphased data with missing windows (n=8),
    and the n=16 likelihood path."""
    import numpy as np

    from smcsmc_tpu.em import EMConfig
    from smcsmc_tpu.lookahead import _native_lookahead
    from smcsmc_tpu.simulate import simulate_seg

    check(_native_lookahead() is not None, "native lookahead did not build")
    out = {}
    for name, n, cfg in [
        ("apf8_unphased_missing", 8,
         EMConfig(num_particles=P, block_size=block, apf=2,
                  apf_trees=apf_trees)),
        ("n16", 16, EMConfig(num_particles=P, block_size=block)),
    ]:
        demo = single_pop_demo(n=n, L=L)
        seg = simulate_seg(demo, seed=11)
        if name.startswith("apf8"):
            seg = unphased_missing(seg)
        stats, logl, diag, secs = _one_chunk(demo, seg, cfg, seed=4)
        ne = pooled_ne(stats)
        check(np.isfinite(logl) and logl < 0, f"{name} LogL {logl}")
        check(within(ne, NE), f"{name} pooled Ne {ne}")
        out[name] = dict(seconds=secs, logl=logl, pooled_ne=ne,
                         segments=diag["segments"], card=card)
    return out


def phase_site_likelihood(P=10000, tol=1e-4) -> dict:
    """The site likelihood on ``P`` random trees against the float64 numpy
    pruning (``kernels/pruning_ref.py``), at n=4 and n=16."""
    from smcsmc_tpu.kernels.pruning_ref import kernel_max_error

    out = {}
    for n in (4, 16):
        err = kernel_max_error(n, num_trees=P, sites=8, seed=0)
        check(err <= tol, f"site likelihood n={n} max error {err} > {tol}")
        out[f"n{n}_max_abs_err"] = err
    return out


# Gates of the device tier that fail on the H100 for a cause measured on
# the card (tools/gate_ab.py) and queued in ROADMAP.md Queue 2.  Phase 6
# runs them with the rest of the tier and reports their outcome; any other
# failure fails the phase.
OPEN_GATES = {
    "test_unidir_migration_per_epoch":
        "epoch-0 migration collapses under the jump walk (Queue 2 item 1)",
    "test_two_pop_split_recovery":
        "no migration direction in epoch 0 (Queue 2 item 2)",
    "test_p10k_precision_estep":
        "pooled Ne above its band, registered from one draw "
        "(Queue 2 item 5)",
    "test_full_em_with_guide_smoothing":
        "iteration-0 pooled Ne above its band, registered from one draw "
        "(Queue 2 item 5)",
}


class _Outcomes:
    """pytest plugin: the outcome of every test, by test name."""

    def __init__(self):
        self.by_name = {}

    def pytest_runtest_logreport(self, report):
        name = report.nodeid.split("::")[-1]
        if report.failed:
            self.by_name[name] = "failed"
        elif report.when == "call" or report.skipped:
            self.by_name.setdefault(name, report.outcome)


def phase_device_tests() -> dict:
    """The gpu-marked device tier (smoke tests and statistical gates), in
    this process."""
    import pytest

    os.environ["SMCSMC_GPU_TESTS"] = "1"
    outcomes = _Outcomes()
    t0 = time.perf_counter()
    rc = int(pytest.main([
        os.path.join(HERE, "tests", "test_gpu_smoke.py"),
        os.path.join(HERE, "tests", "test_gpu_stat_gates.py"),
        "-q", "-p", "no:cacheprovider", "--durations=0",
        "--rootdir", HERE,
    ], plugins=[outcomes]))
    failed = sorted(k for k, v in outcomes.by_name.items() if v == "failed")
    unexpected = [k for k in failed if k not in OPEN_GATES]
    check(rc in (0, 1) and outcomes.by_name,
          f"device test tier did not run (pytest exit code {rc})")
    check(not unexpected, f"device tier failures: {unexpected}")
    for name in failed:
        print(f"[chip_smoke] open gate failed: {name}: {OPEN_GATES[name]}",
              flush=True)
    return dict(seconds=time.perf_counter() - t0, outcomes=outcomes.by_name,
                open_gates_failed=failed)


def phase_chunks(workdir: str, card: str, n_cards: int, P=10000,
                 L=4e6, rtol=1e-5) -> dict:
    """``smc2 -chunks N`` with one worker thread per card, then the same
    command with ``-nothreads``: every chunk must give the same LogL and
    statistics, and the threaded chunks must have run on distinct cards."""
    import numpy as np

    from smcsmc_tpu import cli
    from smcsmc_tpu.segio import write_seg
    from smcsmc_tpu.simulate import simulate_seg

    seg_path = os.path.join(workdir, "chunks.seg")
    write_seg(seg_path, simulate_seg(single_pop_demo(n=4, L=L), seed=43))
    runs = {}
    for mode, extra in (("threads", []), ("nothreads", ["-nothreads"])):
        out_dir = os.path.join(workdir, f"chunks_{mode}")
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = ["-seg", seg_path, "-o", out_dir,
                "-Np", str(P), "-EM", "0", "-N0", "10000", "-mu", "1e-8",
                "-rho", "1e-9", "-P", "133", "133016", "7*1", "-seed", "7",
                "-chunks", str(n_cards)] + extra
        t0 = time.perf_counter()
        with ChunkRecorder() as rec:
            check(cli.smcsmc_main(argv) == 0, f"smc2 -chunks ({mode})")
        runs[mode] = dict(seconds=time.perf_counter() - t0,
                          calls=sorted(rec.calls, key=lambda c: c["chunk"]))
    thr, ser = runs["threads"]["calls"], runs["nothreads"]["calls"]
    check(len(thr) == len(ser) == n_cards, "chunk count")
    devices = sorted({c["device"] for c in thr})
    check(len(devices) == n_cards, f"threaded chunks ran on {devices}")
    worst = 0.0
    for a, b in zip(thr, ser):
        check(a["chunk"] == b["chunk"], "chunk order")
        for x, y in [(a["logl"], b["logl"])] + [
            (np.asarray(u), np.asarray(v))
            for u, v in zip(a["stats"], b["stats"])
        ]:
            rel = np.max(np.abs(x - y) / np.maximum(np.abs(y), 1e-30))
            worst = max(worst, float(rel))
    check(worst <= rtol, f"threaded vs serial chunks differ by {worst}")
    return dict(
        threads_s=runs["threads"]["seconds"],
        nothreads_s=runs["nothreads"]["seconds"],
        devices=devices, max_rel_diff=worst, rtol=rtol,
        chunk_logl=[c["logl"] for c in thr], card=card,
    )


def phase_sharded(card: str, n_cards: int, P=10000, L=2e5, block=1,
                  seeds=tuple(range(3, 11)), n_sd=4.0,
                  min_same=0.9) -> dict:
    """The particle-sharded sweep on a 1-D mesh over the cards against the
    same sweep on one card (tests/test_sharding.py at full width).

    Up to the first resampling step both runs weight the same particles:
    the per-segment ESS must agree to test_sharding's rtol 1e-4, ln_norm
    after each segment to its rtol 1e-5, and the first resample must fire
    at the same segment.  The resample draws ancestors from a CDF that the
    cards sum in another order than one card does, so a last-bit
    difference can give a particle the neighbouring ancestor; at least
    ``min_same`` of the particles must come out of that step with the same
    tree as on one card (a resampling confined to each card's shard would
    move most of them).  From there the filters follow different random
    paths, and the final ln_norm is held statistically: within ``n_sd``
    standard deviations of the one-card ln_norm over ``seeds``."""
    import jax
    import numpy as np

    from smcsmc_tpu.em import prepare_blocks
    from smcsmc_tpu.kernels.tree import epochs_from_demography
    from smcsmc_tpu.parallel.sharding import make_mesh, shard_pf_state
    from smcsmc_tpu.simulate import simulate_seg
    from smcsmc_tpu.smc import (
        PFConfig, build_sweep, default_lags, init_state,
    )

    demo = single_pop_demo(n=4, L=L)
    seg = simulate_seg(demo, seed=21)
    epochs = epochs_from_demography(demo)
    cfg = PFConfig(num_particles=P, num_leaves=4)
    blocks = list(prepare_blocks(seg, block, int(seg.positions[0])))
    lags = default_lags(epochs, RHO)
    sweep = build_sweep(cfg)
    S = seg.num_segments

    def run(mesh, seed):
        """Final state; per-segment ESS, resample flag and ln_norm (one
        segment per block); node times right after the first resample."""
        state = init_state(jax.random.PRNGKey(seed), epochs, cfg,
                           demo.sample_pops, RHO)
        if mesh is not None:
            state = shard_pf_state(state, mesh, P)
        ess, need, ln, after = [], [], [], None
        t0 = time.perf_counter()
        for b in blocks:
            state, (e, r, _) = sweep(state, b, epochs, MU, RHO, lags)
            ess.append(np.asarray(e))
            need.append(np.asarray(r))
            ln.append(float(state.ln_norm))
            if after is None and need[-1].any():
                after = np.asarray(state.trees.time)
        return dict(state=state, seconds=time.perf_counter() - t0,
                    ess=np.concatenate(ess)[:S],
                    need=np.concatenate(need)[:S],
                    ln=np.array(ln)[:S], after=after)

    ones = [run(None, seed) for seed in seeds]  # the first one compiles
    mesh = make_mesh(n_cards)
    run(mesh, seeds[0])  # compile
    shard = run(mesh, seeds[0])
    one = ones[0]
    check(len(shard["state"].log_w.sharding.device_set) == n_cards,
          "sweep state not sharded over the cards")
    check(one["need"].any(), "no resample in the one-card sweep")
    first = int(np.argmax(one["need"]))
    check(int(np.argmax(shard["need"])) == first,
          f"first resample at segment {int(np.argmax(shard['need']))} "
          f"on the cards, {first} on one card")
    rel = np.abs(shard["ess"] - one["ess"]) / one["ess"]
    ln_rel = np.abs(shard["ln"] - one["ln"]) / np.abs(one["ln"])
    check(np.all(rel[:first + 1] <= 1e-4),
          f"ESS differs up to the first resample: {rel[:first + 1].max()}")
    check(np.all(ln_rel[:first + 1] <= 1e-5),
          f"ln_norm differs up to the first resample: "
          f"{ln_rel[:first + 1].max()}")
    same = float(np.mean(np.all(
        np.isclose(shard["after"], one["after"], rtol=1e-5), axis=1)))
    check(same >= min_same,
          f"only {same:.4f} of the particles kept their one-card tree "
          f"through the first resample")
    parted = np.nonzero((rel > 1e-4) | (ln_rel > 1e-5))[0]
    ln_one = [float(r["state"].ln_norm) for r in ones]
    ln4 = float(shard["state"].ln_norm)
    sd = float(np.std(ln_one, ddof=1))
    delta = ln4 - ln_one[0]
    check(np.isfinite(ln4) and ln4 < 0, f"sharded ln_norm {ln4}")
    check(abs(delta) <= n_sd * sd,
          f"sharded ln_norm {ln4} vs one card {ln_one[0]} "
          f"(seed sd {sd}, limit {n_sd} sd)")
    return dict(
        one_card_s=ones[1]["seconds"], sharded_s=shard["seconds"],
        segments=int(S), first_resample_segment=first,
        ess_max_rel_to_first=float(rel[:first + 1].max()),
        ln_norm_max_rel_to_first=float(ln_rel[:first + 1].max()),
        same_tree_share_after_first=same,
        first_parted_segment=int(parted[0]) if parted.size else None,
        ln_norm_one=ln_one, ln_norm_sharded=ln4, delta=delta, seed_sd=sd,
        resamples_one=int(one["state"].num_resamples),
        resamples_sharded=int(shard["state"].num_resamples), card=card,
    )


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def run_phase(name: str, fn, results: dict) -> None:
    t0 = time.perf_counter()
    print(f"[chip_smoke] {name} ...", flush=True)
    out = fn()
    out = dict(out, phase_s=time.perf_counter() - t0)
    results[name] = out
    print(f"[chip_smoke] {name} passed: "
          f"{json.dumps(out, default=float)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="4 runs only the multi-card phases")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "smcsmc_tpu")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    devices = jax.devices()
    if len(devices) < args.chips:
        print(f"chip_smoke: {args.chips} cards asked, {len(devices)} found",
              file=sys.stderr)
        return 2

    from smcsmc_tpu._cache import enable_compilation_cache

    cache = enable_compilation_cache()
    workdir = os.path.join(HERE, "chiprun_out", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    card = card_line()
    print(f"devices: {devices}")
    print(f"device_kind: {devices[0].device_kind}  compile cache: {cache}")
    print(f"card: {card}", flush=True)

    results = {}
    t_start = time.perf_counter()
    try:
        if args.chips > 1:
            n = args.chips
            run_phase("chunks", lambda: phase_chunks(workdir, card, n),
                      results)
            run_phase("sharded_sweep", lambda: phase_sharded(card, n),
                      results)
        else:
            run_phase("smc2", lambda: phase_smc2(workdir, card), results)
            run_phase("migration", lambda: phase_migration(card), results)
            run_phase("features", lambda: phase_features(card), results)
            run_phase("site_likelihood", phase_site_likelihood, results)
            run_phase("device_tests", phase_device_tests, results)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    results["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(workdir, f"results_{args.chips}.json"),
              "w") as fh:
        json.dump(results, fh, indent=1, default=float)
    print(f"card: {card}  total {results['total_s']:.1f} s")
    count = args.chips if args.chips > 1 else len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
