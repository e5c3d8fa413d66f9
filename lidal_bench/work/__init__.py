"""The benchmark's frozen work arithmetic: the H100's peaks, the least time a
kernel could take (:class:`Bound`), and the operations and bytes each kernel
of the port needs for its arguments, counted from the inputs and never from
the kernel.  Later changes to the program do not change these counts.

Every count function takes the kernel's arguments (and its output) and
returns ``(operations, bytes)`` as 0-d tensors on their device, so a caller
can add them up without waiting for the device.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Sequence

import torch

# NVIDIA H100 SXM data-sheet peaks (dense, no sparsity, at the 700 W limit).
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
PEAK_TF32 = 495e12  # dense TF32 on the tensor cores: the fastest rate for f32 operands
PEAK_F32 = 67e12  # f32 FMA outside the tensor cores
PEAK_BF16 = 989e12


class Bound:
    """Sum of the least times the card could take for a kernel's calls:
    per call the larger of operations over the peak rate and bytes over the
    peak bandwidth."""

    def __init__(self, peak_ops: float = PEAK_TF32, peak_bytes: float = PEAK_BYTES):
        self.peak_ops, self.peak_bytes = peak_ops, peak_bytes
        self.s = {"bytes": 0.0, "operations": 0.0}

    def add(self, nbytes: float, ops: float, calls: int = 1) -> float:
        t_bytes, t_ops = nbytes / self.peak_bytes, ops / self.peak_ops
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.s[by] += calls * max(t_bytes, t_ops)
        return max(t_bytes, t_ops)

    @property
    def total(self) -> float:
        return self.s["bytes"] + self.s["operations"]

    @property
    def by(self) -> str:
        """What binds the larger share of the sum."""
        return max(self.s, key=self.s.get)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _real(nbr: torch.Tensor, n: int) -> torch.Tensor:
    return (nbr >= 0) & (nbr < n)


def named_rows(nbr: torch.Tensor, n: int) -> torch.Tensor:
    """Distinct rows in ``[0, n)`` that ``nbr`` names (0-d int64 tensor)."""
    seen = torch.zeros(n + 1, dtype=torch.bool, device=nbr.device)
    seen[torch.where(_real(nbr, n), nbr, n).long().reshape(-1)] = True
    return seen[:n].sum()


def conv_fwd_work(feats, w, nbr, out, scale=None, shift=None):
    """The gather-GEMM ``out[i] = sum_k feats[nbr[i, k]] @ w[k]``: 2 x real
    (row, tap) pairs x cin x cout operations; bytes: the source rows the map
    names, the weights, the map, the epilogue vectors and the output, each
    once."""
    n, cin = feats.shape
    cout = w.shape[-1]
    pairs = _real(nbr, n).sum()
    ops = 2.0 * pairs * cin * cout
    moved = 4.0 * named_rows(nbr, n) * cin + nbytes(w, nbr, out, scale, shift)
    return ops, moved


def conv_bwd_work(src, w2, nbr, f, need_dx, dx, dwg):
    """The backward ``conv_dx_dw(src=dy, w2, nbr, f)``: dx is the gather-GEMM of
    ``src`` over ``nbr`` with ``w2`` (2 x pairs x c_src x c_dst), dW the
    per-tap products of the same pairs with ``f`` (2 x pairs x c_src x
    c_f); bytes: the ``src`` rows the map names, the ``f`` rows with a real
    tap, the weights, the map and the outputs, each once."""
    n, c_src = src.shape
    c_dst, c_f = w2.shape[2], f.shape[1]
    real = _real(nbr, n)
    pairs = real.sum()
    ops = 2.0 * pairs * c_src * ((c_dst if need_dx else 0) + c_f)
    moved = (4.0 * named_rows(nbr, n) * c_src + 4.0 * real.any(1).sum() * c_f
             + nbytes(w2 if need_dx else None, nbr, dx, dwg))
    return ops, moved


def gather8_work(feats, nbr, w8, out):
    """Trilinear ``gather8``: 2 x real pairs x c; bytes: the table rows the
    map names, the map, the weights and the output."""
    n, c = feats.shape
    ops = 2.0 * _real(nbr, n).sum() * c
    moved = 4.0 * named_rows(nbr, n) * c + nbytes(nbr, w8, out)
    return ops, moved


def scatter8_work(dy, nbr, w8, n, out):
    """``scatter8`` (the gather's gradient): 2 x real pairs x c; bytes: the
    ``dy`` rows with a real tap, the map, the weights and the output."""
    c = dy.shape[1]
    real = _real(nbr, n)
    ops = 2.0 * real.sum() * c
    moved = 4.0 * real.any(1).sum() * c + nbytes(nbr, w8, out)
    return ops, moved


def child_sum_work(x, children: Sequence[torch.Tensor], counts, out):
    """The child-sum chain: one add per real child per column and one divide
    per output value; bytes: the child row (32 bytes) of every node reached
    from the last level, every point under it read once, the counts and the
    output."""
    b, cap0, c = x.shape
    caps = [cap0] + [ch.shape[1] for ch in children]
    reached = torch.ones(counts.shape, dtype=torch.bool, device=counts.device)
    node_rows = adds = 0
    for level in reversed(range(len(children))):
        node_rows = node_rows + reached.sum()
        real = _real(children[level], caps[level]) & reached[..., None]
        adds = adds + real.sum() * c
        nxt = torch.zeros((b, caps[level] + 1), dtype=torch.bool, device=counts.device)
        nxt.scatter_(1, torch.where(real, children[level], caps[level]).long().reshape(b, -1),
                     torch.ones(real.shape, dtype=torch.bool, device=counts.device).reshape(b, -1))
        reached = nxt[:, : caps[level]]
    points = reached.sum()
    moved = 32.0 * node_rows + 4.0 * points * c + nbytes(counts, out)
    return adds + float(counts.numel() * c), moved


class Layer(NamedTuple):
    """One layer with weights: ``kind`` is ``subm`` (kernel 3 at ``level``),
    ``down`` (``level`` -> ``level + 1``), ``up`` (``level + 1`` -> ``level``)
    or ``dense`` (a 1x1 conv or a Linear over the valid rows of ``level``)."""

    kind: str
    level: int
    cin: int
    cout: int
    needs_dx: bool


def unet_layers(cs: Sequence[int], in_channels: int, num_classes: int, point_branch: bool) -> List[Layer]:
    """The weighted layers of MinkUNet (reference ``network/minkunet.py``)
    and, with ``point_branch``, SPVCNN's three point Linears
    (``network/spvcnn.py``); the stem's first conv takes no input gradient."""
    out = [Layer("subm", 0, in_channels, cs[0], False), Layer("subm", 0, cs[0], cs[0], True)]

    def res(level, cin, cout):
        out.extend([Layer("subm", level, cin, cout, True), Layer("subm", level, cout, cout, True)])
        if cin != cout:
            out.append(Layer("dense", level, cin, cout, True))

    for i, (cin, cout) in enumerate([(cs[0], cs[1]), (cs[1], cs[2]), (cs[2], cs[3]), (cs[3], cs[4])]):
        out.append(Layer("down", i, cin, cin, True))
        res(i + 1, cin, cout)
        res(i + 1, cout, cout)
    for j, (cin, cout, skip) in enumerate([(cs[4], cs[5], cs[3]), (cs[5], cs[6], cs[2]),
                                           (cs[6], cs[7], cs[1]), (cs[7], cs[8], cs[0])]):
        level = 3 - j
        out.append(Layer("up", level, cin, cout, True))
        res(level, cout + skip, cout)
        res(level, cout, cout)
    out.append(Layer("dense", 0, cs[8], num_classes, True))
    if point_branch:
        for cin, cout in ((cs[0], cs[4]), (cs[4], cs[6]), (cs[6], cs[8])):
            out.append(Layer("dense", 0, cin, cout, True))
    return out


def pass_flops(layers: Iterable[Layer], rows, subm_pairs, down_pairs, train: bool):
    """Useful FLOPs of one pass over a batch: 2 x real pairs x cin x cout per
    layer for the forward and, in training, the same again for dW and for dx
    wherever the layer takes one.  ``rows[l]``: valid voxels of level l;
    ``subm_pairs[l]``: real kernel-3 pairs of level l; ``down_pairs[l]``:
    real pairs between levels l and l + 1."""
    total = 0.0
    for ly in layers:
        pairs = {"subm": subm_pairs, "down": down_pairs, "up": down_pairs, "dense": rows}[ly.kind][ly.level]
        passes = 1 + (1 + int(ly.needs_dx) if train else 0)
        total = total + 2.0 * pairs * ly.cin * ly.cout * passes
    return total
