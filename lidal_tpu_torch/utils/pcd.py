"""Minimal PCD v0.7 IO with a pure-python LZF codec (clean-room; the port's
own copy of ``lidal_tpu/utils/pcd.py``).

Covers the reference's usage surface (``utils/pypcd.py:248,641`` — the VCCS PCD
bridge): ascii / binary / binary_compressed reads, ascii / binary writes.  Our
VCCS runs in-process (``prep/native.py``), so this exists for interop tooling.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_PCD_TYPES = {("F", 4): "f4", ("F", 8): "f8", ("I", 1): "i1", ("I", 2): "i2",
              ("I", 4): "i4", ("U", 1): "u1", ("U", 2): "u2", ("U", 4): "u4"}
_INV_TYPES = {v: k for k, v in _PCD_TYPES.items()}


def lzf_decompress(data: bytes, expected: int) -> bytes:
    """LZF decompression (libLZF format)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out += data[i : i + run]
            i += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            for _ in range(length + 2):
                out.append(out[ref])
                ref += 1
    if len(out) != expected:
        raise ValueError(f"lzf: expected {expected} bytes, got {len(out)}")
    return bytes(out)


def lzf_compress(data: bytes) -> bytes:
    """LZF compression (libLZF stream format, same encoding the reference's
    pypcd gets from the C ``lzf`` module): greedy hash-table matcher emitting
    back-references (offset <= 8191, length 3..264) between literal runs of
    up to 32 bytes.  Round-trips through :func:`lzf_decompress` and through
    libLZF decompressors."""
    n = len(data)
    out = bytearray()
    htab = [-1] * 8192
    lit_start = 0  # start of the pending literal run
    i = 0

    def flush_literals(upto: int) -> None:
        j = lit_start
        while j < upto:
            run = min(32, upto - j)
            out.append(run - 1)
            out.extend(data[j : j + run])
            j += run

    while i + 2 < n:
        h = ((data[i] << 16) | (data[i + 1] << 8) | data[i + 2])
        slot = ((h * 2654435761) >> 16) & 8191
        ref = htab[slot]
        htab[slot] = i
        off = i - ref - 1
        if (
            ref >= 0
            and off < 8192
            and data[ref] == data[i]
            and data[ref + 1] == data[i + 1]
            and data[ref + 2] == data[i + 2]
        ):
            length = 3
            maxlen = min(264, n - i)
            while length < maxlen and data[ref + length] == data[i + length]:
                length += 1
            flush_literals(i)
            enc = length - 2
            if enc < 7:
                out.append((enc << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(enc - 7)
            out.append(off & 0xFF)
            i += length
            lit_start = i
        else:
            i += 1
    flush_literals(n)
    return bytes(out)


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Returns {field_name: column}; multi-count fields get _0.._k suffixes."""
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode(errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        mode = header["DATA"][0]

        names, fmts = [], []
        for fld, s, t, c in zip(fields, sizes, types, counts):
            for j in range(c):
                names.append(fld if c == 1 else f"{fld}_{j}")
                fmts.append("<" + _PCD_TYPES[(t, s)])
        dtype = np.dtype(list(zip(names, fmts)))

        if mode == "ascii":
            rows = np.loadtxt([f.readline() for _ in range(n)], dtype=np.float64, ndmin=2)
            data = np.zeros(n, dtype)
            for i, nm in enumerate(names):
                data[nm] = rows[:, i]
        elif mode == "binary":
            data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif mode == "binary_compressed":
            comp_size, uncomp_size = np.frombuffer(f.read(8), np.uint32)
            raw = lzf_decompress(f.read(int(comp_size)), int(uncomp_size))
            # binary_compressed stores columns contiguously (SoA)
            data = np.zeros(n, dtype)
            off = 0
            for nm, fmt in zip(names, fmts):
                w = np.dtype(fmt).itemsize
                data[nm] = np.frombuffer(raw[off : off + n * w], fmt, count=n)
                off += n * w
        else:
            raise ValueError(f"unknown DATA mode {mode}")
    return {nm: np.ascontiguousarray(data[nm]) for nm in names}


def write_pcd(
    path: str,
    columns: Dict[str, np.ndarray],
    binary: bool = True,
    mode: str | None = None,
) -> None:
    """``mode`` in {"ascii", "binary", "binary_compressed"} (reference
    pypcd.py:641 supports all three); the legacy ``binary`` flag maps to
    binary/ascii when ``mode`` is not given."""
    if mode is None:
        mode = "binary" if binary else "ascii"
    assert mode in ("ascii", "binary", "binary_compressed"), mode
    names = list(columns)
    cols = [np.asarray(columns[nm]) for nm in names]
    n = len(cols[0])
    assert all(len(c) == n for c in cols)
    types, sizes = [], []
    for c in cols:
        t, s = _INV_TYPES[c.dtype.str[1:]]
        types.append(t)
        sizes.append(str(s))
    header = "\n".join(
        [
            "# .PCD v0.7 - Point Cloud Data file format",
            "VERSION 0.7",
            "FIELDS " + " ".join(names),
            "SIZE " + " ".join(sizes),
            "TYPE " + " ".join(types),
            "COUNT " + " ".join(["1"] * len(names)),
            f"WIDTH {n}",
            "HEIGHT 1",
            "VIEWPOINT 0 0 0 1 0 0 0",
            f"POINTS {n}",
            f"DATA {mode}",
        ]
    )
    dtype = np.dtype([(nm, "<" + c.dtype.str[1:]) for nm, c in zip(names, cols)])
    rec = np.zeros(n, dtype)
    for nm, c in zip(names, cols):
        rec[nm] = c
    with open(path, "wb") as f:
        f.write((header + "\n").encode())
        if mode == "binary":
            f.write(rec.tobytes())
        elif mode == "binary_compressed":
            # columns stored contiguously (SoA), lzf'd, prefixed by
            # [compressed_size, uncompressed_size] uint32 (pypcd format)
            soa = b"".join(np.ascontiguousarray(rec[nm]).tobytes() for nm in names)
            comp = lzf_compress(soa)
            f.write(np.array([len(comp), len(soa)], np.uint32).tobytes())
            f.write(comp)
        else:
            for row in rec:
                f.write((" ".join(repr(float(v)) if isinstance(v, np.floating) else str(v) for v in row) + "\n").encode())
