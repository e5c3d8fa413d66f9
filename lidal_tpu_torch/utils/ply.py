"""Minimal PLY point-cloud IO (the port's own copy of ``lidal_tpu/utils/ply.py``;
clean-room; covers the reference's usage surface,
``utils/ply.py:92,186`` — read/write of vertex-element clouds, ascii and
binary_little_endian)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element; returns {property_name: array}."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
        while True:
            line = f.readline().strip().decode()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append((name, int(count), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    raise NotImplementedError("list properties not supported")
                elements[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))
            elif line == "end_header":
                break
        out: Dict[str, np.ndarray] = {}
        for name, count, props in elements:
            dtype = np.dtype(
                [(p, ("<" if fmt == "binary_little_endian" else ">") + t) for p, t in props]
            )
            if fmt == "ascii":
                rows = np.loadtxt([f.readline() for _ in range(count)], dtype=np.float64, ndmin=2)
                data = np.zeros(count, dtype=dtype)
                for i, (p, _) in enumerate(props):
                    data[p] = rows[:, i]
            else:
                data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype, count=count)
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(data[p])
    return out


def write_ply(
    path: str,
    arrays: Sequence[np.ndarray],
    names: Sequence[str],
    binary: bool = True,
) -> None:
    """Write a single 'vertex' element.  ``arrays`` are per-property columns (a
    [n, k] array contributes k consecutive names)."""
    cols: List[np.ndarray] = []
    for a in arrays:
        a = np.asarray(a)
        if a.ndim == 1:
            cols.append(a)
        else:
            cols.extend(a[:, i] for i in range(a.shape[1]))
    assert len(cols) == len(names), (len(cols), len(names))
    n = len(cols[0])
    assert all(len(c) == n for c in cols)

    dtype = np.dtype([(nm, "<" + c.dtype.str[1:]) for nm, c in zip(names, cols)])
    rec = np.zeros(n, dtype=dtype)
    for nm, c in zip(names, cols):
        rec[nm] = c

    with open(path, "wb") as f:
        fmt = "binary_little_endian" if binary else "ascii"
        header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
        for nm, c in zip(names, cols):
            header.append(f"property {_INV_DTYPES[c.dtype.str[1:]]} {nm}")
        header.append("end_header")
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                f.write((" ".join(str(v) for v in row) + "\n").encode())
