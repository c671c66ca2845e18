"""``smc2``-compatible command line interface.

Option surface follows the reference (smcsmc/model.py:91-306 option table;
src/pfparam.cpp:63-169 binary flags), with the same 11-step run sequence
(cli.py:12 ``smcsmc_main``): parse -> validate -> segfiles -> chunks ->
pattern -> EM loop -> merge.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np

logger = logging.getLogger("smcsmc_tpu")


def load_option_file(argv: list[str]) -> list[str]:
    """-@ file indirection (model.py:331-342): tokens from the file are
    spliced in at the option's position."""
    out = []
    i = 0
    while i < len(argv):
        if argv[i] == "-@":
            with open(argv[i + 1]) as fh:
                for line in fh:
                    line = line.split("#")[0].strip()
                    if line:
                        out += line.split()
            i += 2
        else:
            out.append(argv[i])
            i += 1
    return out


def parse_smc2_args(argv: list[str]):
    """Split smc2 options into driver settings + demography flags.

    Returns (EMConfig-kwargs, demography-args, io dict)."""
    from .em import EMConfig

    argv = load_option_file(argv)
    cfg = EMConfig()
    io = {
        "segs": [],
        "out": "smcsmc_out",
        "pattern": None,  # (start, end, pattern)
        "maxgap": 200000,
        "minseg": 500000,
        "startpos": 1,
        "length": None,
        "arg": False,
        "mu": None,
        "rho": None,
        "N0": None,  # default: Watterson θ̂/(4μ) (model.py:705-711)
        "nsam": None,
        "calibrate_lag": 2.0,
        "alpha": 0.0,
        "bias_heights": None,
        "tmax": 2.0,  # -tmax: max tree height in 4N0 units (pfparam.cpp:242)
        "p_pattern": None,  # -p: binary-style epoch pattern (pfparam.cpp:105)
        "logfile": None,  # -log FILE: log file override (model.py:415-417)
        "cluster": False,  # -c: multi-process (jax.distributed) execution
    }
    demo_args: list[str] = []
    i = 0
    while i < len(argv):
        o = argv[i]

        def take(k=1):
            nonlocal i
            vals = argv[i + 1 : i + 1 + k]
            i += 1 + k
            return vals if k > 1 else vals[0]

        if o in ("-seg", "-segs"):
            # -segs takes multiple files
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                io["segs"].append(argv[i])
                i += 1
        elif o == "-o":
            io["out"] = take()
        elif o == "-Np":
            cfg.num_particles = int(take())
        elif o == "-EM":
            cfg.em_iters = int(take())
        elif o == "-ESS":
            cfg.ess_threshold = float(take())
        elif o == "-P":
            io["pattern"] = take(3)
        elif o == "-N0":
            io["N0"] = float(take())
        elif o == "-mu":
            io["mu"] = float(take())
        elif o == "-rho":
            io["rho"] = float(take())
        elif o == "-t":
            demo_args += ["-t", take()]
        elif o == "-r":
            r, L = take(2)
            demo_args += ["-r", r, L]
        elif o == "-length":
            io["length"] = float(take())
        elif o == "-nsam":
            io["nsam"] = int(take())
        elif o == "-lag":
            cfg.lag = float(take())
        elif o == "-calibrate_lag":
            cfg.calibrate_lag = True
            cfg.lag_fraction = float(take())
        elif o == "-cap":
            cfg.use_cap = True
            cfg.ne_cap = float(take())
        elif o == "-ancestral_aware":
            cfg.ancestral_aware = True
            i += 1
        elif o == "-dephase":
            cfg.dephase = True
            i += 1
        elif o == "-online":
            cfg.online = True
            i += 1
        elif o in ("-xr", "-xc"):
            # epoch or 0-based closed epoch range, e.g. "0-10"
            # (pfparam.cpp:82-99 readRange + record_event_in_epoch masks)
            spec = take()
            lo, _, hi = spec.partition("-")
            epochs_rng = tuple(range(int(lo), int(hi or lo) + 1))
            if o == "-xr":
                cfg.xr_epochs = tuple(cfg.xr_epochs) + epochs_rng
            else:
                cfg.xc_epochs = tuple(cfg.xc_epochs) + epochs_rng
        elif o == "-apf":
            # auxiliary particle filter level 0-4 (pfparam.cpp:147-151)
            cfg.apf = int(take())
        elif o == "-tmax":
            # maximum tree height for -p epoch spacing, in 4N0 units
            # (pfparam.cpp:103-104, default 2)
            io["tmax"] = float(take())
        elif o == "-p":
            # binary-style PSMC pattern, log-spaced on [0, tmax]
            # (pfparam.cpp:105-107 + pattern.cpp:139-149)
            io["p_pattern"] = take()
        elif o == "-delay_coal":
            # delay keyed off the first coalescence height (pfparam.cpp:140)
            cfg.delay_type = "coal"
            i += 1
        elif o == "-delay_migr":
            # delay keyed off the first coal-or-migration event
            # (pfparam.cpp:141-142 RESAMPLE_DELAY_COALMIGR)
            cfg.delay_type = "migr"
            i += 1
        elif o == "-no_infer_recomb":
            # keep the recombination rate fixed across M-steps
            # (model.py:403-405)
            cfg.infer_recomb = False
            i += 1
        elif o == "-no_m_step":
            # run E-steps only; parameters stay at their initial values
            # (model.py:406-408, 1020-1022)
            cfg.do_m_step = False
            i += 1
        elif o == "-log":
            # -log FILE names the python-level log (model.py:415-417); the
            # bare binary -log bool (pfparam.cpp:158) is a no-op here since
            # result.log is always written
            if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                io["logfile"] = take()
            else:
                i += 1
        elif o == "-c":
            # reference: submit chunks via SGE qsub (model.py:254-257).  The
            # equivalent here is multi-process chunk parallelism over
            # jax.distributed: launch one smc2 -c process per host with
            # SMCSMC_COORD/SMCSMC_NPROC/SMCSMC_PID set (or a cluster
            # environment jax.distributed can auto-detect) and run_chunks
            # partitions the chunks across processes (docs/deployment.md
            # "Multi-host launch").
            io["cluster"] = True
            i += 1
        elif o == "-C":
            take()  # cluster config string (model.py:258-260): no-op
        elif o == "-vb":
            cfg.vb = True
            i += 1
        elif o == "-chunks":
            cfg.chunks = int(take())
        elif o == "-ckpt":
            # mid-sweep orbax checkpoint interval in blocks (0 = off)
            cfg.checkpoint_blocks = int(take())
        elif o == "-nproc":
            # concurrent chunk workers, one device each (the reference's
            # process-level chunk parallelism, execute.py:26-105; 0 = one
            # worker per local device)
            cfg.chunk_workers = int(take())
        elif o == "-nothreads":
            # serialize chunk sweeps (model.py:1094-1100)
            cfg.chunk_workers = 1
            i += 1
        elif o == "-maxgap":
            io["maxgap"] = int(float(take()))
        elif o == "-minseg":
            io["minseg"] = int(float(take()))
        elif o == "-startpos":
            io["startpos"] = int(float(take()))
        elif o == "-seed":
            cfg.seed = int(take())
        elif o == "-arg":
            io["arg"] = True
            cfg.record_arg = True
            i += 1
        elif o == "-record_ess":
            cfg.record_ess = True
            i += 1
        elif o == "-bias_heights":
            # reference fork flag: heights in units of 4*N0 generations,
            # first entry typically 0 (pfparam/scrm -bias_heights)
            i += 1
            hs = []
            while i < len(argv) and not argv[i].startswith("-"):
                hs.append(float(argv[i]))
                i += 1
            io["bias_heights"] = hs
        elif o == "-bias_strengths":
            i += 1
            ss = []
            while i < len(argv) and not argv[i].startswith("-"):
                ss.append(float(argv[i]))
                i += 1
            cfg.bias_strengths = tuple(ss)
        elif o == "-delay":
            cfg.delay = float(take())
        elif o == "-lag_fraction":
            cfg.lag_fraction = float(take())
        elif o == "-alpha":
            # fraction of posterior recombination mixed into the guide
            # (model.py:246-249); > 0 activates the record->smooth->guide
            # loop, < 0 disables recording
            io["alpha"] = float(take())
            cfg.alpha = io["alpha"]
        elif o == "-guide":
            # explicit recombination guide file (model.py:1060-1061)
            cfg.guide_file = take()
        elif o == "-migbuf":
            # per-branch migration-event buffer capacity (0 = auto-sized
            # from the demography; the reference's scrm node chains are
            # unbounded, so this knob exists only here: device buffers
            # have a fixed size)
            cfg.mig_buffer = int(take())
        elif o == "-smcsmcpath":
            take()  # compatibility no-op: there is no external binary
        elif o in ("-v", "--version"):
            from . import __version__

            print(f"smcsmc_tpu {__version__}")
            sys.exit(0)
        elif o in ("-h", "--help"):
            print_help()
            sys.exit(0)
        elif o in (
            "-I",
            "-eI",
            "-ej",
            "-eM",
            "-ema",
            "-em",
            "-eN",
            "-en",
            "-M",
        ):
            # demography flags pass through with their arguments
            demo_args.append(o)
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                demo_args.append(argv[i])
                i += 1
        else:
            raise SystemExit(f"smc2: unknown option {o!r}")
    return cfg, demo_args, io


def print_help():
    print(
        """smc2 (smcsmc_tpu) — demographic inference with particle filters in JAX

Usage: smc2 [options] -seg FILE [FILE...]

Core options (reference parity: smcsmc/model.py, src/pfparam.cpp):
  -seg FILE...       input .seg file(s)
  -o DIR             output directory [smcsmc_out]
  -Np INT            number of particles [100]
  -EM INT            number of EM iterations [0]
  -ESS FLOAT         resampling threshold as fraction of Np [0.5]
  -N0 FLOAT          baseline effective population size [10000]
  -mu FLOAT          mutation rate /nt/gen
  -rho FLOAT         recombination rate /nt/gen
  -length FLOAT      sequence length
  -nsam INT          number of haplotypes
  -P S E PATT        log-spaced epochs, e.g. -P 133 133016 31*1
  -I/-eI/-ej/-eN/-en/-eM/-em/-ema   ms/scrm demography flags
  -lag FLOAT         fixed lag (bp); default: per-epoch 4/(rho*top_t)
  -cap FLOAT         cap inferred Ne
  -vb                variational-Bayes smoothing of the M-step
  -chunks INT        genome chunks processed independently [1]
  -maxgap/-minseg    chunking controls
  -ancestral_aware   allele 0 is ancestral
  -alpha FLOAT       recombination-guide mix-in fraction (0 disables) [0]
  -guide FILE        explicit recombination guide file
  -seed INT          random seed
  -@ FILE            read options from file
"""
    )


TIMED_FLAGS = ("-eI", "-ej", "-eM", "-ema", "-em", "-eN", "-en")


def _split_timed_opts(args: list[str]):
    """Partition flat scrm args into timed options [(time, [flag, t, ...])]
    and the remainder (reference set_pattern, model.py:483-491)."""
    timed, remain = [], []
    i = 0
    while i < len(args):
        o = args[i]
        grp = [o]
        i += 1
        while i < len(args) and not (
            args[i].startswith("-") and not _is_number(args[i])
        ):
            grp.append(args[i])
            i += 1
        if o in TIMED_FLAGS:
            timed.append((float(grp[1]), grp))
        else:
            remain += grp
    return timed, remain


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def resolve_n0(io, seg=None):
    """Default N0 = Watterson θ̂ / (4 μ) when -N0 is absent
    (reference model.py:705-711; θ̂ from model.py:567-621)."""
    if io["N0"] is not None:
        return io["N0"]
    if io["mu"] is not None and seg is not None:
        from .segio import watterson_estimate

        theta_w = watterson_estimate(
            seg, startpos=io.get("startpos"), length=io.get("length")
        )
        if theta_w > 0:
            n0 = theta_w / (4.0 * io["mu"])
            logger.info(
                "Setting N0 from mutation rate and Watterson's estimate "
                "of theta (%.4g): N0 = %.1f", theta_w, n0,
            )
            io["N0"] = n0
            return n0
    raise SystemExit(
        "smc2: N0 required -- use -N0, or (implicitly) -mu with seg data"
    )


def build_demography(cfg, demo_args, io, seg=None):
    """Assemble the Demography from flags (+ -P pattern rewriting of ALL
    timed options onto the log-spaced epoch grid, model.py:470-536;
    Watterson default N0, model.py:705-711)."""
    from .demography import parse_scrm_args
    from .pattern import smc2_pattern_times

    n0 = resolve_n0(io, seg)
    args = list(demo_args)
    # translate -mu/-rho/-length into -t / -r
    L = io["length"]
    if L is None and seg is not None:
        L = float(seg.end)
    if L is None:
        L = 2e7
    if io["mu"] is not None and "-t" not in args:
        args += ["-t", str(4 * n0 * io["mu"] * L)]
    if io["rho"] is not None and "-r" not in args:
        args += ["-r", str(4 * n0 * io["rho"] * L), str(L)]
    if io["nsam"] is not None and "-nsam" not in args:
        args += ["-nsam", str(io["nsam"])]
    elif seg is not None and "-nsam" not in args and "-I" not in args:
        args += ["-nsam", str(seg.num_samples)]

    if io["pattern"] is None and io.get("p_pattern"):
        # binary-style -p/-tmax epoch grid (pfparam.cpp:290-296): pattern
        # times are in 4N0 units already (pattern.cpp:139-149)
        from .pattern import epoch_times_from_pattern

        times_4n0 = epoch_times_from_pattern(io["p_pattern"], io["tmax"])
        for t in times_4n0:
            if t > 0:
                args += ["-eN", str(t), "1.0"]
        logger.info(
            "Epoch grid from -p %s -tmax %g: %s",
            io["p_pattern"], io["tmax"],
            " ".join(f"{t:.4g}" for t in times_4n0),
        )

    if io["pattern"] is not None:
        # -P start end pattern (model.py:470-536 set_pattern): generate the
        # log-spaced epoch grid, re-emit user -eN sizes carried forward onto
        # grid times, and snap every other timed option's time to the
        # largest grid time <= its own.  User -eN rows are consumed; -en
        # rows are left as-is (reference note: best not combined with -P).
        start, end, patt = io["pattern"]
        times = smc2_pattern_times(float(start), float(end), patt, n0=n0)
        timed, remain = _split_timed_opts(args)
        new_timed = []
        for t in times:
            # last user -eN with time <= t sets the size (default 1.0)
            size = "1.0"
            best = -1.0
            for ut, grp in timed:
                if grp[0] == "-eN" and ut <= t and ut >= best:
                    best, size = ut, grp[2]
            new_timed.append((t, ["-eN", str(t), size]))
        for ut, grp in timed:
            if grp[0] == "-eN":
                continue
            below = [t for t in times if t <= ut]
            newtime = below[-1] if below else times[0]
            new_timed.append((newtime, [grp[0], str(newtime)] + grp[2:]))
        new_timed.sort(key=lambda x: x[0])
        args = remain + [tok for _, grp in new_timed for tok in grp]
        logger.info(
            "Population structure options after -P: %s",
            " ".join(" ".join(grp) for _, grp in new_timed),
        )

    demo = parse_scrm_args(args, n0=n0)
    if L is not None:
        demo.sequence_length = L
    return demo


def _log_parameters(cfg, demo, io):
    """Echo the resolved run configuration into result.log (the reference
    writes the same inventory via PfParam::writeLog, pfparam.cpp:403-456)."""
    from . import __version__

    lines = [
        "###########################",
        "#        smc2 log         #",
        "###########################",
        f"version: {__version__}",
        "smcsmc parameters:",
        f"  Segment data files: {io['segs'] or 'empty'}",
        f"  Recombination guide file: {cfg.guide_file or 'None'}",
        f"  EM steps = {cfg.em_iters}",
    ]
    if cfg.lag > 0:
        lines.append(f"  Constant lag = {cfg.lag}")
    if cfg.calibrate_lag:
        lines.append(f"  Calibrated lag = {cfg.lag_fraction} x survival")
    if cfg.online:
        lines.append("  Online update = TRUE")
    lines += [
        f"  N (particles) = {cfg.num_particles}",
        f"  ESS threshold = {cfg.ess_threshold}",
        f"  chunks = {cfg.chunks}  workers = {cfg.chunk_workers}",
        f"  VB = {cfg.vb}  APF = {cfg.apf}  alpha = {cfg.alpha}",
        f"  seed = {cfg.seed}",
        "model parameters:",
        f"  Sample size = {demo.num_samples}",
        f"  Seq length = {demo.sequence_length:g}",
        f"  mutation rate = {demo.mutation_rate:g}",
        f"  recomb rate = {demo.recombination_rate:g}",
        "  Pop size (at Generation):",
    ]
    for e in range(demo.num_epochs):
        sizes = " | ".join(f"{s:10.1f}" for s in demo.pop_sizes[e])
        lines.append(f"  ({demo.change_times[e]:10.1f} ) {sizes}")
    lines.append(f"Out file is saved in file: {io['out']}/result.out")
    for ln in lines:
        logger.info("%s", ln)


def _maybe_init_distributed(cluster: bool) -> bool:
    """Join the jax.distributed runtime before any device use.

    Two activation paths (docs/deployment.md "Multi-host launch"):
    - ``SMCSMC_COORD`` (host:port) + ``SMCSMC_NPROC`` + ``SMCSMC_PID`` in
      the environment — explicit coordination, works on any backend
      (the launcher example starts one smc2 process per host this way);
    - ``-c`` with no env vars — ``jax.distributed.initialize()`` with
      auto-detection (cluster environments); degrades to a
      warning and single-process execution when no cluster environment is
      detectable.
    Returns True when a multi-process runtime was joined."""
    coord = os.environ.get("SMCSMC_COORD")
    if coord:
        from .parallel import distributed as dist

        nproc = int(os.environ["SMCSMC_NPROC"])
        pid = int(os.environ["SMCSMC_PID"])
        dist.initialize(coord, nproc, pid)
        logger.info(
            "joined jax.distributed: process %d/%d via %s", pid, nproc, coord
        )
        return True
    if cluster:
        import jax

        try:
            jax.distributed.initialize()
        except Exception as exc:  # no detectable cluster environment
            logger.warning(
                "-c: no cluster environment detected (%s); running "
                "single-process (set SMCSMC_COORD/SMCSMC_NPROC/SMCSMC_PID "
                "to coordinate explicitly)", exc,
            )
            return False
        logger.info(
            "joined jax.distributed: process %d/%d (auto-detected)",
            jax.process_index(), jax.process_count(),
        )
        return True
    return False


def smcsmc_main(argv=None):
    from ._cache import enable_compilation_cache
    from .em import run_em
    from .segio import merge_segs, read_seg

    enable_compilation_cache()
    if os.environ.get("SMCSMC_DEBUG_NANS"):
        # debug analogue of the reference's FP-exception traps
        # (smcsmc.cpp:52-54 feenableexcept): raise at the first NaN-producing
        # op instead of at the per-block finite check
        import jax

        jax.config.update("jax_debug_nans", True)

    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        print_help()
        return 1
    cfg, demo_args, io = parse_smc2_args(argv)

    multiproc = _maybe_init_distributed(io["cluster"])
    pid = 0
    if multiproc:
        import jax

        pid = jax.process_index()

    os.makedirs(io["out"], exist_ok=True)
    logfile = io["logfile"] or os.path.join(io["out"], "result.log")
    if pid > 0:
        logfile += f".p{pid}"  # per-process logs (shared-FS collision)
    logging.basicConfig(filename=logfile, level=logging.INFO)
    logger.info("smc2 %s", " ".join(argv))

    if not io["segs"]:
        raise SystemExit("smc2: no -seg input given")
    if len(io["segs"]) > 1:
        seg, _ = merge_segs(io["segs"], gap=io["maxgap"])
    else:
        seg = read_seg(io["segs"][0])

    demo = build_demography(cfg, demo_args, io, seg=seg)
    _log_parameters(cfg, demo, io)
    if io["bias_heights"]:
        # convert 4N0 units -> generations; drop a leading 0
        hs = [h * 4 * io["N0"] for h in io["bias_heights"] if h > 0]
        cfg.bias_heights = tuple(hs)
    cfg.outdir = io["out"]
    # chunk-window controls (model.py:563-662; pfparam.cpp -startpos)
    cfg.maxgap = io["maxgap"]
    cfg.minseg = io["minseg"]
    if io["startpos"] > 1:
        cfg.startpos = float(io["startpos"])
    if io["length"] is not None:
        cfg.length = float(io["length"])
    result = run_em(demo, seg, cfg)
    logger.info("final log-likelihoods: %s", result.log_likelihoods)
    if pid == 0:
        print(f"Results written to {io['out']}/result.out")
    return 0


if __name__ == "__main__":
    sys.exit(smcsmc_main())
