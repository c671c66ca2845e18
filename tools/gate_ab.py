"""Re-run the device tier's open statistical gates under controlled
variants, to tell a band registered from one draw from an estimator that
moved.

    python tools/gate_ab.py [--out chiprun_out/gate_ab.jsonl] [--until T]

Each run is one gate of ``tests/test_gpu_stat_gates.py`` (its own data and
configuration, through its ``run_*`` helper) at one filter seed, under one
variant:

- ``formula``: the site likelihood's branch mutation probability as
  ``-expm1(-mu t)`` (the kernel's) or as ``1 - exp(-mu t)`` (the formula
  before it, which is 0 in float32 for mu t below ~6e-8);
- ``walk``: the migration walk, ``jump`` (the default) or ``loop``
  (``SMCSMC_MIG_WALK=loop``).

Every run appends one JSON line to ``--out``: gate, variant, seed, EM
iterations, wall seconds, the statistics each gate bands, and the verdict
of the gate's own check where the run has the gate's EM depth (the split
gate checks iteration 0 only, so it is judged at any depth).  Runs that
would start later than ``--until`` (Unix seconds) are skipped, so a caller
can bound the whole call.  Run it on the card: on the CPU the gates take
hours.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_gpu_stat_gates as gates  # noqa: E402
from smcsmc_tpu.kernels import likelihood  # noqa: E402

# (formula, walk, gate, seed, EM iterations, expected seconds), grouped by
# variant so that each compiles once.  The formula before expm1 comes first:
# a device-tier run has already given each gate's reading with expm1 at the
# gate's own seed.
PLAN = (
    [("1-exp", "jump", "split", 1, 0, 90),
     ("1-exp", "jump", "unidir", 1, 2, 220)]
    + [("1-exp", "jump", "p10k", s, 0, 30) for s in range(7, 13)]
    + [("1-exp", "jump", "guide", 1, 0, 60)]
    + [("expm1", "jump", "p10k", s, 0, 30) for s in range(7, 13)]
    + [("expm1", "jump", "guide", 1, 0, 60),
       ("expm1", "jump", "split", 1, 0, 60),
       ("expm1", "loop", "split", 1, 0, 120)]
)


def set_variant(formula: str, walk: str) -> None:
    if formula == "expm1":
        likelihood.jnp = jnp
    else:
        shim = types.SimpleNamespace(**vars(jnp))
        shim.expm1 = lambda y: jnp.exp(y) - 1.0
        likelihood.jnp = shim
    os.environ["SMCSMC_MIG_WALK"] = walk
    jax.clear_caches()  # retrace every jitted sweep under the variant


def dev(x: float, truth: float) -> float:
    return float(x) / truth - 1.0


def rates(st) -> np.ndarray:
    return st.mig_cnt / np.maximum(st.mig_opp[:, :, None], 1e-300)


def run_gate(gate: str, seed: int, em_iters: int, workdir: str):
    """The gate's run, its banded statistics, and its own check."""
    if gate == "p10k":
        stats, logl = gates.run_p10k(seed=seed)
        out = dict(pooled_ne_dev=dev(gates._pooled_ne(stats), 1e4),
                   r_dev=dev(stats.recomb_cnt.sum() / stats.recomb_opp.sum(),
                             1e-9), logl=float(logl))
        return out, lambda: gates.check_p10k(stats, logl), True
    if gate == "guide":
        outdir = os.path.join(workdir, f"guide_{seed}_{time.time_ns()}")
        res = gates.run_guide(outdir, seed=seed, em_iters=em_iters)
        out = dict(
            pooled_ne_dev=[dev(gates._pooled_ne(st), 1e4) for st in res.stats],
            r_dev=[dev(st.recomb_cnt.sum() / st.recomb_opp.sum(), 1e-9)
                   for st in res.stats])
        return out, lambda: gates.check_guide(res), em_iters == 2
    run = {"split": gates.run_split, "unidir": gates.run_unidir}[gate]
    check = {"split": gates.check_split, "unidir": gates.check_unidir}[gate]
    res = run(seed=seed, em_iters=em_iters)
    out = dict(
        mig_rates=[rates(st).tolist() for st in res.stats],
        ne=[(st.coal_opp / (2.0 * st.coal_cnt)).tolist() for st in res.stats],
        logl=[float(x) for x in res.log_likelihoods])
    return out, lambda: check(res), gate == "split" or em_iters == 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "gate_ab.jsonl"))
    ap.add_argument("--until", type=float, default=float("inf"),
                    help="skip runs that would start after this Unix time")
    args = ap.parse_args(argv)
    workdir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                           "gate_ab")
    os.makedirs(workdir, exist_ok=True)
    current = None
    for formula, walk, gate, seed, em_iters, est in PLAN:
        if time.time() + est > args.until:
            print(f"gate_ab: skipped {gate} {formula}/{walk} seed {seed}",
                  flush=True)
            continue
        if (formula, walk) != current:
            set_variant(formula, walk)
            current = (formula, walk)
        t0 = time.perf_counter()
        out, check, judged = run_gate(gate, seed, em_iters, workdir)
        verdict = None
        if judged:
            try:
                check()
                verdict = "pass"
            except AssertionError as exc:
                where = traceback.extract_tb(exc.__traceback__)[-1].line
                what = str(exc) or where
                verdict = "fail: " + " ".join(what.split())[:200]
        line = dict(gate=gate, formula=formula, walk=walk, seed=seed,
                    em_iters=em_iters, seconds=time.perf_counter() - t0,
                    check=verdict, **out)
        print("GATE_AB", json.dumps(line), flush=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(line) + "\n")
    set_variant("expm1", "jump")
    return 0


if __name__ == "__main__":
    sys.exit(main())
