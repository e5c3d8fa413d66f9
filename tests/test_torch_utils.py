"""The port's own utilities (``lidal_tpu_torch/utils``): the PLY / PCD IO and
LZF codec round trips of ``tests/test_io.py``, each also read back by the JAX
package's reader (and the JAX package's files by the port's), the LZF streams
bit-equal to the JAX package's; ``device_trace`` and the determinism audit
as in ``tests/test_utils_misc.py``, over torch tensors and state dicts (the
recorder's spans and counters: ``tests/test_torch_tracing.py``)."""

import os

import numpy as np
import torch

from lidal_tpu.utils import pcd as jax_pcd
from lidal_tpu.utils import ply as jax_ply
from lidal_tpu.utils.determinism import tree_fingerprint as jax_tree_fingerprint
from lidal_tpu_torch.models.minkunet import MinkUNet
from lidal_tpu_torch.utils import pcd, ply
from lidal_tpu_torch.utils.determinism import check_deterministic, tree_fingerprint
from lidal_tpu_torch.utils.profiling import device_trace
from tests.test_torch_minkunet import NARROW


def test_ply_roundtrip_binary_and_ascii(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(100, 3)).astype(np.float32)
    labels = rng.integers(0, 20, 100).astype(np.uint32)
    for binary in (True, False):
        p = str(tmp_path / f"t_{binary}.ply")
        ply.write_ply(p, [xyz, labels], ["x", "y", "z", "label"], binary=binary)
        out = ply.read_ply(p)
        np.testing.assert_allclose(out["x"], xyz[:, 0], rtol=1e-6)
        np.testing.assert_allclose(out["z"], xyz[:, 2], rtol=1e-6)
        np.testing.assert_array_equal(out["label"], labels)


def test_pcd_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    cols = {
        "x": rng.normal(size=50).astype(np.float32),
        "y": rng.normal(size=50).astype(np.float32),
        "z": rng.normal(size=50).astype(np.float32),
        "label": rng.integers(0, 9, 50).astype(np.uint32),
    }
    for binary in (True, False):
        p = str(tmp_path / f"t_{binary}.pcd")
        pcd.write_pcd(p, cols, binary=binary)
        out = pcd.read_pcd(p)
        np.testing.assert_allclose(out["x"], cols["x"], rtol=1e-6)
        np.testing.assert_array_equal(out["label"], cols["label"])


def test_lzf_roundtrip():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 255, 10_000).astype(np.uint8).tobytes()
    comp = pcd.lzf_compress(data)
    out = pcd.lzf_decompress(comp, len(data))
    assert out == data
    # compressible data with back-references from a real-ish LZF stream:
    # literals + a run — construct manually: 'abcabcabc...'
    pattern = b"abc" * 100
    comp2 = pcd.lzf_compress(pattern)
    assert pcd.lzf_decompress(comp2, len(pattern)) == pattern


def test_lzf_backreference_decode():
    # hand-crafted stream: literal 'ab', then back-ref len 4 (ctrl len=2 -> 2+2)
    # offset 2 -> expands 'abab'; total 'ababab'... verify known vector
    stream = bytes([0x01, ord("a"), ord("b"), (2 << 5) | 0, 1])
    out = pcd.lzf_decompress(stream, 6)
    assert out == b"abABAB".lower()


def test_pcd_binary_compressed_read(tmp_path):
    # write a binary_compressed file by hand (SoA layout) and read it back
    n = 20
    x = np.arange(n, dtype=np.float32)
    lab = (np.arange(n) % 3).astype(np.uint32)
    soa = x.tobytes() + lab.tobytes()
    comp = pcd.lzf_compress(soa)
    header = "\n".join(
        [
            "VERSION 0.7",
            "FIELDS x label",
            "SIZE 4 4",
            "TYPE F U",
            "COUNT 1 1",
            f"WIDTH {n}",
            "HEIGHT 1",
            "VIEWPOINT 0 0 0 1 0 0 0",
            f"POINTS {n}",
            "DATA binary_compressed",
        ]
    )
    p = str(tmp_path / "c.pcd")
    with open(p, "wb") as f:
        f.write((header + "\n").encode())
        f.write(np.array([len(comp), len(soa)], np.uint32).tobytes())
        f.write(comp)
    out = pcd.read_pcd(p)
    np.testing.assert_allclose(out["x"], x)
    np.testing.assert_array_equal(out["label"], lab)


def test_pcd_binary_compressed_write_roundtrip(tmp_path):
    """write_pcd(mode="binary_compressed") reads back identically and the
    stream genuinely compresses repetitive data (real LZF back-refs, not a
    literal-only stream)."""
    rng = np.random.default_rng(5)
    n = 400
    cols = {
        "x": np.repeat(rng.normal(size=40).astype(np.float32), 10),  # redundant
        "y": rng.normal(size=n).astype(np.float32),
        "label": (np.arange(n) % 4).astype(np.uint32),
    }
    p = str(tmp_path / "c.pcd")
    pcd.write_pcd(p, cols, mode="binary_compressed")
    out = pcd.read_pcd(p)
    for k in cols:
        np.testing.assert_array_equal(out[k], cols[k])
    raw = sum(c.nbytes for c in cols.values())
    assert os.path.getsize(p) < raw  # repetitive columns must shrink


def test_lzf_compress_efficiency_and_edges():
    # long self-overlapping run (RLE-style back-refs), exact round-trip
    for data in (b"", b"a", b"ab", b"a" * 5000, bytes(range(256)) * 40,
                 b"the quick brown fox " * 64):
        comp = pcd.lzf_compress(data)
        assert pcd.lzf_decompress(comp, len(data)) == data
    assert len(pcd.lzf_compress(b"a" * 5000)) < 200  # genuine compression


def test_files_and_streams_cross_the_packages(tmp_path):
    rng = np.random.default_rng(7)
    xyz = rng.normal(size=(60, 3)).astype(np.float32)
    labels = rng.integers(0, 20, 60).astype(np.uint32)
    cols = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2], "label": labels}
    for writer, reader in ((ply, jax_ply), (jax_ply, ply)):
        for binary in (True, False):
            p = str(tmp_path / f"x_{writer.__name__}_{binary}.ply")
            writer.write_ply(p, [xyz, labels], ["x", "y", "z", "label"], binary=binary)
            out = reader.read_ply(p)
            np.testing.assert_allclose(out["y"], xyz[:, 1], rtol=1e-6)
            np.testing.assert_array_equal(out["label"], labels)
    for writer, reader in ((pcd, jax_pcd), (jax_pcd, pcd)):
        for mode in ("ascii", "binary", "binary_compressed"):
            p = str(tmp_path / f"x_{writer.__name__}_{mode}.pcd")
            writer.write_pcd(p, cols, mode=mode)
            out = reader.read_pcd(p)
            np.testing.assert_allclose(out["z"], cols["z"], rtol=1e-6)
            np.testing.assert_array_equal(out["label"], labels)
    for data in (b"", bytes(range(256)) * 9, b"abcab" * 300, rng.integers(0, 4, 5000).astype(np.uint8).tobytes()):
        assert pcd.lzf_compress(data) == jax_pcd.lzf_compress(data)


def test_device_trace_noop_and_trace(tmp_path):
    with device_trace(None):
        pass  # no-op path
    with device_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    files = os.listdir(tmp_path / "trace")
    files.remove("summary.json")
    assert len(files) == 1 and files[0].endswith(".json")


def test_determinism_audit():
    def good():
        return {"x": torch.arange(4), "y": {"z": torch.ones(3)}}

    ok, bad = check_deterministic(good)
    assert ok and not bad

    state = {"n": 0}

    def flaky():
        state["n"] += 1
        return torch.full((3,), state["n"])

    ok, bad = check_deterministic(flaky)
    assert not ok and len(bad) == 1

    fp = tree_fingerprint({"a": np.ones(3)})
    assert len(fp) == 1
    # the leaf paths and hashes of numpy trees are the JAX package's
    tree = {"b": [np.arange(3, dtype=np.int32), np.zeros((2, 2), np.float32)], "a": {"c": np.ones(1)}}
    assert tree_fingerprint(tree) == jax_tree_fingerprint(tree)
    # a state dict: one leaf per tensor; a changed weight changes one hash
    torch.manual_seed(0)
    sd = MinkUNet(num_classes=4, cs=NARROW).state_dict()
    fp = tree_fingerprint(sd)
    assert len(fp) == len(sd) and fp == tree_fingerprint({k: v.clone() for k, v in sd.items()})
    sd["classifier.0.bias"] = sd["classifier.0.bias"] + 1
    assert sum(a != b for a, b in zip(fp.values(), tree_fingerprint(sd).values())) == 1
    assert len(set(tree_fingerprint({"h": torch.zeros(2, dtype=torch.bfloat16), "f": torch.zeros(1)}).values())) == 2
