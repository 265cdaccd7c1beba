"""The port's multi-process harness for tests/test_torch_multihost*.py: N real OS processes of
tests/torch_multihost_worker.py over gloo on 127.0.0.1, each on a free port, every wait under
a timeout that kills them all. The trio and config are tests/test_multihost.py's; the golden
report is the JAX package's single-process run_trio on the same BAMs."""

import os
import socket
import subprocess
import sys

from test_multihost import SPEC  # the JAX harness's trio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")
CFG = dict(k=21, max_read_len=64, batch_reads=64, table_capacity=1 << 13, accum_batches=2)
TIMEOUT = 240  # seconds for the slowest worker of one launch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def launch(n_procs, trio_dir, out, extra=()):
    port = free_port()
    return [subprocess.Popen([sys.executable, WORKER, str(pid), str(n_procs), str(port),
                              trio_dir, out, *extra],
                             env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for pid in range(n_procs)]


def wait_all(procs, timeout=TIMEOUT):
    """[(returncode, stdout, stderr)] of every process; on a timeout every process is
    killed and the run fails."""
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise AssertionError(f"a worker outlived {timeout} s; all were killed")
        outs.append((p.returncode, out.decode(), err.decode()))
    return outs


def run_ok(n_procs, trio_dir, out, extra=()):
    results = wait_all(launch(n_procs, trio_dir, out, extra))
    for rc, _so, se in results:
        assert rc == 0, f"worker failed rc={rc}\nstderr:\n{se[-3000:]}"
    return results


def reports(out, n_procs):
    """Every rank's report text."""
    texts = []
    for pid in range(n_procs):
        with open(f"{out}.rank{pid}") as f:
            texts.append(f.read())
    return texts


def jax_report(trio_dir):
    from denovo_kmer_tpu.config import EngineConfig
    from denovo_kmer_tpu.pipeline import run_trio

    res = run_trio(*(os.path.join(trio_dir, f"{s}.bam") for s in ("mom", "dad", "child")),
                   EngineConfig(**CFG))
    return res.report


def write_trio(d):
    from denovo_kmer_tpu.io.synth import make_trio, write_trio_bams

    write_trio_bams(make_trio(SPEC), str(d))
    return str(d)
