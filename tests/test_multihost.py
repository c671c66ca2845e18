"""Multi-process (multi-"host") chunk parallelism over jax.distributed —
the cross-host story of SURVEY.md §2.4/§5.8 (reference: one SGE process
per chunk, execute.py:26-105, stats summed across .out files,
model.py:903-910).

Spawns two coordinated CPU processes, each running ONE genome chunk of the
same dataset, reduces the sufficient statistics across processes, and
checks the result equals the serial two-chunk run in this process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_threefry_partitionable", True)
from smcsmc_tpu.parallel import distributed as dist
dist.initialize({coord!r}, 2, int(sys.argv[1]))
assert jax.process_count() == 2, jax.process_count()

import numpy as np
from smcsmc_tpu.demography import Demography
from smcsmc_tpu.em import EMConfig, run_chunk
from smcsmc_tpu.segio import define_chunks
from smcsmc_tpu.simulate import simulate_seg

demo = Demography(
    change_times=np.array([0.0]),
    pop_sizes=np.array([[10000.0]]),
    mig_rates=np.zeros((1, 1, 1)),
    sample_pops=np.zeros(2, dtype=np.int32),
    mutation_rate=1e-8,
    recombination_rate=1e-9,
    sequence_length=2e5,
)
seg = simulate_seg(demo, seed=17)
chunks = define_chunks(seg, 2, minseg=1000)
assert len(chunks) == 2
me = int(sys.argv[1])
cfg = EMConfig(num_particles=32, block_size=64)
ch = chunks[me]
stats, stats_wt, logl, diag = run_chunk(
    demo, seg, cfg, chunk=(ch.start, ch.end), seed=100 + me
)
# the cross-process reduction: one all-reduce of the [E,...] tensors + the
# scalar log-likelihood
merged = dist.allreduce_stats(stats)
logl_sum = dist.allreduce_scalar(logl)
if me == 0:
    out = {{
        "coal_opp": np.asarray(merged.coal_opp).tolist(),
        "coal_cnt": np.asarray(merged.coal_cnt).tolist(),
        "recomb_cnt": np.asarray(merged.recomb_cnt).tolist(),
        "logl": logl_sum,
        "process_count": jax.process_count(),
    }}
    with open(sys.argv[2], "w") as fh:
        json.dump(out, fh)
print("WORKER_DONE", me, flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_chunk_parallelism(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=REPO, coord=coord))
    outfile = str(tmp_path / "merged.json")
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")
    }
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), outfile],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
        assert f"WORKER_DONE {i}" in out
    with open(outfile) as fh:
        merged = json.load(fh)
    assert merged["process_count"] == 2

    # serial oracle in this process: same chunks, same seeds, summed here
    from smcsmc_tpu.demography import Demography
    from smcsmc_tpu.em import EMConfig, run_chunk, sum_stats
    from smcsmc_tpu.segio import define_chunks
    from smcsmc_tpu.simulate import simulate_seg

    demo = Demography(
        change_times=np.array([0.0]),
        pop_sizes=np.array([[10000.0]]),
        mig_rates=np.zeros((1, 1, 1)),
        sample_pops=np.zeros(2, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=2e5,
    )
    seg = simulate_seg(demo, seed=17)
    chunks = define_chunks(seg, 2, minseg=1000)
    cfg = EMConfig(num_particles=32, block_size=64)
    per = [
        run_chunk(demo, seg, cfg, chunk=(c.start, c.end), seed=100 + i)
        for i, c in enumerate(chunks)
    ]
    stats = sum_stats([p[0] for p in per])
    logl = sum(p[2] for p in per)
    np.testing.assert_allclose(
        np.asarray(merged["coal_opp"]), np.asarray(stats.coal_opp), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(merged["coal_cnt"]), np.asarray(stats.coal_cnt), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(merged["recomb_cnt"]), np.asarray(stats.recomb_cnt),
        rtol=1e-6,
    )
    np.testing.assert_allclose(merged["logl"], logl, rtol=1e-6)


@pytest.mark.slow
def test_cli_multiprocess_launch(tmp_path):
    """VERDICT r4 item 7: the multi-host path driven through the ``smc2``
    CLI entry itself — two coordinated processes launched with
    SMCSMC_COORD/SMCSMC_NPROC/SMCSMC_PID and ``-c``, chunk-partitioned by
    run_chunks, aggregate .out written by process 0 and identical to the
    single-process run of the same command."""
    from smcsmc_tpu.demography import Demography
    from smcsmc_tpu.segio import write_seg
    from smcsmc_tpu.simulate import simulate_seg

    demo = Demography(
        change_times=np.array([0.0]),
        pop_sizes=np.array([[10000.0]]),
        mig_rates=np.zeros((1, 1, 1)),
        sample_pops=np.zeros(2, dtype=np.int32),
        mutation_rate=1e-8,
        recombination_rate=1e-9,
        sequence_length=2e5,
    )
    seg = simulate_seg(demo, seed=17)
    segfile = str(tmp_path / "data.seg")
    write_seg(segfile, seg)

    args = ["-seg", segfile, "-nsam", "2", "-N0", "10000", "-mu", "1e-8",
            "-rho", "1e-9", "-Np", "32", "-EM", "0", "-P", "133", "35000",
            "2*1", "-chunks", "2", "-minseg", "1000", "-c"]

    def launch(outdir, multi):
        base = {
            k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")
        }
        base["PYTHONPATH"] = REPO
        base["JAX_PLATFORMS"] = "cpu"
        cmd = [sys.executable, "-m", "smcsmc_tpu.cli",
               "-o", outdir] + args
        if not multi:
            ps = [subprocess.Popen(cmd, env=base, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)]
        else:
            coord = f"localhost:{_free_port()}"
            ps = []
            for pid in range(2):
                env = dict(base, SMCSMC_COORD=coord, SMCSMC_NPROC="2",
                           SMCSMC_PID=str(pid))
                ps.append(subprocess.Popen(
                    cmd, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=900)[0] for p in ps]
        for p, out in zip(ps, outs):
            assert p.returncode == 0, out[-2000:]
        return outs

    launch(str(tmp_path / "multi"), multi=True)
    launch(str(tmp_path / "solo"), multi=False)

    multi_out = (tmp_path / "multi" / "result.out").read_text()
    solo_out = (tmp_path / "solo" / "result.out").read_text()
    assert multi_out == solo_out
    # only process 0 wrote the aggregate file set
    assert (tmp_path / "multi" / "result.log.p1").exists()
