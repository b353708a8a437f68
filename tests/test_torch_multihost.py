"""``bbmap_tpu_torch.parallel.multihost`` against the JAX package's
``parallel/multihost.py``, and the port's gloo process group on the CPU.

The host helpers (stripes, shard paths, ``ShardWriter`` with
``merge_shards`` in global batch order) give the JAX module's outputs
byte for byte; ``finish_stripes``, the end every striped tool shares,
merges the outputs and sums the hosts' counts on host 0. Two ranks
started as processes join one gloo group, all-gather variable-length data
(``sharded.xh_allgather_varlen``) and leave it so that a second ``init``
in the same process starts clean; a rank whose peer never comes exits
non-zero within its timeout; ``hosts=2`` with ``device=cuda`` and no card
raises before it waits on a peer. The file barrier's cleanup waits until
every host has passed the barrier (the JAX module deletes the markers a
host still polling may need). Tolerance: exact.

``run_ranks`` and ``free_port`` are the harness of the other two-process
tests (``test_torch_parallel_cli.py``, ``test_torch_tools.py``,
``test_torch_hosttools.py``): every rank a subprocess, a port of its own,
``communicate(timeout=...)``, and every rank killed when one fails.
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bbmap_tpu.parallel import multihost as jmh
from bbmap_tpu_torch.parallel import multihost as tmh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(argvs, timeout: float = 300.0, env_extra=None):
    """Start ``python <argv>`` for every argv at once from the repository
    root (one CPU thread each, no card) and wait for all of them: a list
    of (returncode, stdout, stderr). Every rank still running when one
    fails or the timeout passes is killed."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    deadline = time.time() + timeout
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
            results.append((p.returncode, out, err))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def cli_ranks(tool: str, args, n: int = 2, timeout: float = 300.0,
              coordinator: bool = False):
    """``python -m bbmap_tpu_torch <tool> ... hosts=n hostid=i`` for every
    rank at once (``coordinator=localhost:<free port>`` where the tool
    joins a process group); asserts every rank exits 0 and returns their
    stderr."""
    extra = [f"coordinator=localhost:{free_port()}"] if coordinator else []
    res = run_ranks([["-m", "bbmap_tpu_torch", tool, *args, f"hosts={n}",
                      f"hostid={i}", *extra] for i in range(n)],
                    timeout=timeout)
    errs = [r[2][-3000:] for r in res]
    assert len(res) == n and all(r[0] == 0 for r in res), errs
    return [r[2] for r in res]


@pytest.mark.parametrize("n, pid", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_stripe_batches_as_the_jax_module(n, pid):
    items = [f"batch{i}" for i in range(10)]
    assert list(tmh.stripe_batches(iter(items), pid, n)) == \
        list(jmh.stripe_batches(iter(items), pid, n))
    assert [i for i, _ in tmh.stripe_batches(iter(items), pid, n)] == \
        list(range(pid, 10, n))


def test_shard_path_as_the_jax_module():
    for base, pid in (("/x/out.sam", 0), ("/x/out.fq.gz", 3), ("o", 12)):
        assert tmh.shard_path(base, pid) == jmh.shard_path(base, pid)


def _write_shards(mod, base, n_hosts: int, n_batches: int, header: bool):
    """Each host writes its stripe of batches (and host 0's header, and a
    header on every host when ``header``) through ``mod.ShardWriter``."""
    for h in range(n_hosts):
        w = mod.ShardWriter(str(base), h)
        if header:
            w.write_header(b"@HD\tVN:1.4\n@SQ\tSN:h%d\n" % h)
        for b in range(h, n_batches, n_hosts):
            w.write_batch(b, b"".join(b"read%d.%d\n" % (b, j)
                                      for j in range(b % 3 + 1)))
        w.close()


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_shard_writer_merge_in_global_order(tmp_path, n_hosts):
    """ShardWriter + merge_shards reassemble the batches in global order
    behind host 0's header, byte-equal to the JAX module, and delete the
    shards and their sidecars."""
    got = {}
    for name, mod in (("port", tmh), ("jax", jmh)):
        d = tmp_path / name
        d.mkdir()
        _write_shards(mod, d / "out.sam", n_hosts, 8, header=True)
        mod.merge_shards(str(d / "out.sam"), n_hosts)
        got[name] = (d / "out.sam").read_bytes()
        assert [p.name for p in d.iterdir()] == ["out.sam"]
    want = b"@HD\tVN:1.4\n@SQ\tSN:h0\n" + b"".join(
        b"read%d.%d\n" % (b, j) for b in range(8) for j in range(b % 3 + 1))
    assert got["port"] == got["jax"] == want


def test_finish_stripes_merges_and_sums(tmp_path):
    """Two hosts (threads) close their shards of two outputs and call
    finish_stripes: host 0 gets the counts summed (numbers, arrays, lists,
    dicts key by key, None where every host has None) and both outputs
    merged in batch order; host 1 gets None; no shard, sidecar or marker
    is left."""
    outs = [str(tmp_path / "a.fq"), str(tmp_path / "b.fq")]
    counts = [{"n": 5, "hist": np.array([1, 2, 3], np.int64),
               "pairs": [1, 1], "scafs": {"x": 1}, "none": None},
              {"n": 7, "hist": np.array([0, 4, 1], np.int64),
               "pairs": [2, 0], "scafs": {"y": 3, "x": 2}, "none": None}]
    got, errors = {}, []

    def host(h):
        try:
            for path in outs:
                w = tmh.ShardWriter(path, h)
                for b in range(h, 5, 2):
                    w.write_batch(b, b"%s%d\n" % (path[-4:].encode(), b))
                w.close()
            got[h] = tmh.finish_stripes("t-done", h, 2, outs[0], counts[h],
                                        outs)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=host, args=(h,)) for h in (1, 0)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20.0)
    assert not errors and not any(t.is_alive() for t in threads), errors
    total = got[0]
    assert got[1] is None and total["n"] == 12 and total["none"] is None
    np.testing.assert_array_equal(total["hist"], [1, 6, 4])
    assert total["hist"].dtype == np.int64
    assert total["pairs"] == [3, 1] and total["scafs"] == {"x": 3, "y": 3}
    for path in outs:
        assert open(path, "rb").read() == b"".join(
            b"%s%d\n" % (path[-4:].encode(), b) for b in range(5))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a.fq", "b.fq"]


def test_barrier_cleanup_waits_for_every_host(tmp_path):
    """Host 1 reaches the barrier first and polls; host 0 passes it and
    cleans up at once. Host 1 still passes (the cleanup waits for its
    "passed" marker), and no marker is left."""
    base = str(tmp_path / "out.sam")
    errors = []

    def host1():
        try:
            tmh.barrier("t", 1, 2, base, timeout=5.0)
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=host1)
    t.start()
    time.sleep(0.2)
    tmh.barrier("t", 0, 2, base, timeout=5.0)
    tmh.barrier_cleanup("t", 2, base, timeout=5.0)
    t.join(10.0)
    assert not t.is_alive() and not errors, errors
    assert not list(tmp_path.iterdir())


def test_barrier_times_out_without_a_peer(tmp_path):
    with pytest.raises(TimeoutError):
        tmh.barrier("alone", 0, 2, str(tmp_path / "o"), timeout=0.3)


def test_init_one_host_is_a_noop():
    assert tmh.init("localhost:1", 1, 0) == 0
    assert not torch.distributed.is_initialized()
    tmh.shutdown()


_TWO_RANKS = r"""
import sys
import time
import numpy as np
import torch.distributed as dist
from bbmap_tpu_torch.parallel import multihost, sharded
addr, rank = sys.argv[1], int(sys.argv[2])
linger = float(sys.argv[3]) if len(sys.argv) > 3 else 0.0
for round_ in range(2):          # the second init starts clean
    assert multihost.init(addr, 2, rank, timeout=240) == rank
    assert dist.get_world_size() == 2 and dist.get_rank() == rank
    assert sharded.crosshost_mesh("cpu").shape == {"data": 1, "index": 2}
    flat = np.arange(3 + 4 * rank, dtype=np.int64) * (rank + 1)
    lens = np.array([1 + rank, 2 + 3 * rank], np.int64)
    flats, lens_all = sharded.xh_allgather_varlen(flat, lens)
    assert [f.tolist() for f in flats] == [
        list(range(3)), [2 * i for i in range(7)]], flats
    assert lens_all.tolist() == [[1, 2], [2, 5]], lens_all
    multihost.barrier("t", rank, 2)
    if rank == 0:
        time.sleep(linger)       # rank 0 last to leave
    multihost.shutdown()
    assert not dist.is_initialized()
print("RANK_OK", rank)
"""


def test_two_ranks_init_gather_and_restart():
    """Two processes join the gloo group, all-gather data of different
    lengths in rank order, pass the group's barrier, leave, and join a
    second time."""
    addr = f"localhost:{free_port()}"
    # the store waits up to 240 s for the second rank, well inside the
    # ranks' 300 s deadline: under many test workers a rank can take
    # more than a minute to start
    res = run_ranks([["-c", _TWO_RANKS, addr, str(r)] for r in range(2)],
                    timeout=300)
    assert [r[0] for r in res] == [0, 0], [r[2][-2000:] for r in res]
    assert [r[1].split() for r in res] == [["RANK_OK", "0"],
                                           ["RANK_OK", "1"]]


def test_restart_while_rank0_lingers():
    """Rank 0 stays 3 s in the first group after the barrier, so the other
    rank joins the second round at the same address before rank 0 has
    left the first: it must reach the second group's store, not the
    first's."""
    addr = f"localhost:{free_port()}"
    res = run_ranks([["-c", _TWO_RANKS, addr, str(r), "3"]
                     for r in range(2)], timeout=300)
    assert [r[0] for r in res] == [0, 0], [r[2][-2000:] for r in res]
    assert [r[1].split() for r in res] == [["RANK_OK", "0"],
                                           ["RANK_OK", "1"]]


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_whose_peer_never_comes_fails(rank):
    """A rank alone in a group of two exits non-zero within its timeout
    (3 s here), whether it serves the group (rank 0) or joins it."""
    addr = f"localhost:{free_port()}"
    script = ("import sys\nfrom bbmap_tpu_torch.parallel import multihost\n"
              f"multihost.init({addr!r}, 2, {rank}, timeout=3)\n")
    t0 = time.time()
    res = run_ranks([["-c", script]], timeout=90)
    assert res[0][0] != 0, res[0][2][-2000:]
    assert time.time() - t0 < 60


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: 'cuda' is valid here")
def test_hosts_on_cuda_without_a_card_raises(tmp_path):
    """hosts=2 with the default device=cuda and no card raises before it
    joins (or waits on) a process group."""
    from bbmap_tpu_torch.tools import bbmap
    (tmp_path / "ref.fa").write_text(">c\n" + "ACGT" * 100 + "\n")
    (tmp_path / "r.fq").write_text("@r\n" + "ACGT" * 10 + "\n+\n"
                                   + "I" * 40 + "\n")
    with pytest.raises(RuntimeError, match="cuda"):
        bbmap.main([f"ref={tmp_path}/ref.fa", f"in={tmp_path}/r.fq",
                    f"out={tmp_path}/o.sam", "nodisk", "hosts=2",
                    "hostid=0", f"coordinator=localhost:{free_port()}"])
    assert not torch.distributed.is_initialized()
