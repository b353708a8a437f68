"""The port's counting Bloom filter (``bbmap_tpu_torch/index/kcount.py``)
against the JAX package's numpy ``KCountArray`` and its device class
``DeviceKCountArray`` (run on the CPU), tolerance 0: counter rows, count-min
reads and ``used_fraction`` over k-mers up to 2**62 - 1 with repeats, at
1 and 3 hashes, 2 to 32 bits a cell and 2**12 to 2**20 cells.

Documented deviation from the JAX device class: it adds without
saturating (``bbmap_tpu/index/kcount.py:155-161``), so once a cell passes
``cell_max`` its raw rows, and ``bbnorm khist=``, which histograms row 0,
differ from the numpy class's. The port clamps each row after its
scatter-add: its rows equal the numpy class's at every depth, and the JAX
device class's clipped to ``cell_max``. Reads agree with both (both clip).
"""

import numpy as np
import pytest
import torch

from bbmap_tpu.index import kcount as jkc
from bbmap_tpu_torch import convert
from bbmap_tpu_torch.index import kcount as tkc

# (hashes, cell_bits, cells): every hash count, cell width and table size
# at least once
SHAPES = [(1, 2, 1 << 12), (3, 2, 1 << 16), (1, 8, 1 << 12),
          (3, 8, 1 << 20), (1, 16, 1 << 16), (3, 16, 1 << 20),
          (1, 32, 1 << 20), (3, 32, 1 << 12), (3, 4, 1 << 16)]


def _kmers(rng, n):
    """n k-mers in [0, 2**62) with the extremes, repeats of a few, and one
    k-mer 300 times (past cell_max at 2 and 8 bits)."""
    km = rng.integers(0, 2 ** 62, n, dtype=np.int64)
    km[:2] = (0, 2 ** 62 - 1)
    return np.concatenate([km, km[:n // 4], np.repeat(km[5:9], 20),
                           np.full(300, km[3])])


def _batches(km):
    return [km[i:i + 1500] for i in range(0, len(km), 1500)]


@pytest.mark.parametrize("hashes, cell_bits, cells", SHAPES)
def test_rows_reads_and_load_match(hashes, cell_bits, cells):
    rng = np.random.default_rng(hashes * 100 + cell_bits)
    km = _kmers(rng, 4000)
    host = jkc.KCountArray(cells, cell_bits=cell_bits, hashes=hashes)
    jdev = jkc.DeviceKCountArray(cells, cell_bits=cell_bits, hashes=hashes)
    port = tkc.make_kca(cells, cell_bits=cell_bits, hashes=hashes,
                        device="cpu")
    assert port.array.dtype == (torch.int64 if cell_bits == 32
                                else torch.int32)
    tkc.reset_calls()
    for b in _batches(km):
        host.increment(b)
        jdev.increment(b)
        port.increment(b)
    rows = port.array.numpy()
    np.testing.assert_array_equal(rows, host.array.astype(np.int64))
    raw = np.asarray(jdev.array).astype(np.int64)
    np.testing.assert_array_equal(rows, np.minimum(raw, host.cell_max))
    if raw.max() <= host.cell_max:
        np.testing.assert_array_equal(rows, raw)
    else:
        assert cell_bits <= 8          # the JAX device class's deviation
    q = np.concatenate([km[:2000], rng.integers(0, 2 ** 62, 2000,
                                                dtype=np.int64)])
    got = port.read(q)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, host.read(q))
    np.testing.assert_array_equal(got, jdev.read(q))
    assert port.used_fraction() == host.used_fraction()
    assert port.used_fraction() == jdev.used_fraction()
    assert tkc.calls == {"increment": len(_batches(km)), "read": 1}
    assert len(port.read(q[:0])) == 0
    port.increment(q[:0])
    np.testing.assert_array_equal(port.array.numpy(), rows)


@pytest.mark.parametrize("salt", range(len(jkc._MASKS)))
def test_int64_mix_is_the_uint64_mix(salt):
    rng = np.random.default_rng(salt)
    x = np.concatenate([rng.integers(0, 2 ** 63 - 1, 20000, dtype=np.int64),
                        np.array([0, 1, 2 ** 62 - 1, 2 ** 63 - 1],
                                 np.int64)])
    got = tkc.DeviceKCountArray._mix_int64(torch.from_numpy(x),
                                           tkc._SALTS[salt])
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  jkc._mix(x, jkc._MASKS[salt]))
    assert tkc._MASKS == jkc._MASKS


@pytest.mark.parametrize("cls", ["KCountArray", "DeviceKCountArray"])
def test_convert_carries_the_rows(cls):
    """convert.kca: a JAX filter's rows on the port's class, which then
    reads and counts on as the numpy class does."""
    rng = np.random.default_rng(9)
    km = _kmers(rng, 3000)
    ref = getattr(jkc, cls)(1 << 14, cell_bits=8, hashes=3)
    host = jkc.KCountArray(1 << 14, cell_bits=8, hashes=3)
    for b in _batches(km):
        ref.increment(b)
        host.increment(b)
    got = convert.kca(ref, "cpu")
    assert type(got) is tkc.DeviceKCountArray
    assert (got.cells, got.cell_bits, got.hashes, got.cell_max) == \
        (ref.cells, ref.cell_bits, ref.hashes, ref.cell_max)
    np.testing.assert_array_equal(got.array.numpy(), host.array)
    np.testing.assert_array_equal(got.read(km), ref.read(km))
    more = rng.integers(0, 2 ** 62, 2000, dtype=np.int64)
    got.increment(more)
    host.increment(more)
    np.testing.assert_array_equal(got.array.numpy(), host.array)
    assert got.used_fraction() == host.used_fraction()


def test_cells_round_up_to_a_power_of_two():
    port = tkc.make_kca(5000, cell_bits=16, hashes=2, device="cpu")
    host = jkc.KCountArray(5000, cell_bits=16, hashes=2)
    assert port.cells == host.cells == 8192 and port.mask == 8191
    km = np.arange(0, 40000, 7, dtype=np.int64)
    port.increment(km)
    host.increment(km)
    np.testing.assert_array_equal(port.array.numpy(), host.array)


def test_device_must_be_given_and_exist():
    with pytest.raises(TypeError):
        tkc.make_kca(1 << 12)                     # no device given
    with pytest.raises(ValueError):
        tkc.make_kca(1 << 12, device=None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: 'cuda' is valid here")
    with pytest.raises(RuntimeError):
        tkc.make_kca(1 << 12, device="cuda")


def test_card_rows_and_reads_match_numpy():
    """On the card: rows and reads equal the numpy class's (needs a CUDA
    device; chip_smoke.py's kmer tools phase does the same at BBNorm's
    size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    for hashes, cell_bits, cells in SHAPES:
        km = _kmers(rng, 4000)
        host = jkc.KCountArray(cells, cell_bits=cell_bits, hashes=hashes)
        card = tkc.make_kca(cells, cell_bits=cell_bits, hashes=hashes,
                            device="cuda")
        for b in _batches(km):
            host.increment(b)
            card.increment(b)
        np.testing.assert_array_equal(card.array.cpu().numpy(),
                                      host.array.astype(np.int64))
        np.testing.assert_array_equal(card.read(km), host.read(km))
        assert card.used_fraction() == host.used_fraction()


@pytest.mark.parametrize("bits", [2, 16])
def test_bbnorm_khist_against_both_jax_classes(tmp_path, monkeypatch,
                                               capsys, bits):
    """bbnorm khist= on reads from a 300 bp region (depth ~130): the
    port's CLI writes the JAX CLI's files with the numpy filter
    (BBMAP_DEVICE_KCA=0). With the JAX device filter (=1) khist is the
    same at 16 bits; at 2 bits (cell_max 3) it lists depths above 3: the
    documented deviation, its first diverging field."""
    from bbmap_tpu.tools import bbnorm as jbbnorm
    from bbmap_tpu_torch.tools import bbnorm as tbbnorm
    rng = np.random.default_rng(5)
    g = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 2000))
    with open(tmp_path / "r.fq", "w") as f:
        for i in range(400):
            at = int(rng.integers(1000, 1200)) if i % 2 else \
                int(rng.integers(0, len(g) - 100))
            f.write(f"@r{i}\n{g[at:at + 100].decode()}\n+\n{'I' * 100}\n")
    files = {}
    for side, run, env in (("port", tbbnorm.main, None),
                           ("host", jbbnorm.main, "0"),
                           ("jdev", jbbnorm.main, "1")):
        if env is not None:
            monkeypatch.setenv("BBMAP_DEVICE_KCA", env)
        args = [f"in={tmp_path / 'r.fq'}", f"out={tmp_path}/{side}.fq",
                f"khist={tmp_path}/{side}_khist.txt", "target=20", "k=25",
                f"bits={bits}", "cells=4096"]
        capsys.readouterr()
        assert run(args + (["device=cpu"] if side == "port" else [])) == 0
        files[side] = ((tmp_path / f"{side}.fq").read_bytes(),
                       (tmp_path / f"{side}_khist.txt").read_text(),
                       capsys.readouterr().err)
    assert files["port"] == files["host"]
    depths = [int(ln.split("\t")[0])
              for ln in files["jdev"][1].splitlines()[1:]]
    if bits == 16:
        assert files["jdev"] == files["port"]
        assert max(depths) > 3
    else:
        assert files["port"][1] != files["jdev"][1]
        assert max(depths) > 3
        assert max(int(ln.split("\t")[0])
                   for ln in files["port"][1].splitlines()[1:]) == 3
