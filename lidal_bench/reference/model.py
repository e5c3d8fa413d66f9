"""Plain PyTorch MinkUNet and SPVCNN (reference ``network/minkunet.py``,
``network/spvcnn.py``) over one batch of :class:`data.Frame` tables, in
train mode: masked batch-statistics BN, per-frame dropout in SPVCNN.

Each sparse conv is a loop over its taps, ``out[rows] += x[src] @ W[k]``
over the real pairs of the tap only.  Parameter names follow the
reference's module tree (``stem.0.kernel``, ``stage1.1.net.3.kernel``,
``up1.0.net.0.kernel``, ``classifier.0.weight``,
``point_transforms.0.0.weight``), conv kernels ``[K, cin, cout]`` with
x-major taps, so one weight dictionary loads into either side.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch
from torch import nn

from lidal_bench.reference.data import Frame

_CS = (32, 32, 64, 128, 256, 256, 128, 96, 96)


class Conv(nn.Module):
    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, cin, cout))


class BN(nn.Module):
    """Train mode: batch statistics over the rows of ``x`` (every row is a
    valid voxel), kept as the running statistics when ``calibrate`` is set;
    eval mode: the running statistics."""

    calibrate = False

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return (x - self.running_mean) * torch.rsqrt(self.running_var + 1e-5) * self.weight + self.bias
        n = max(x.shape[0], 1)
        mean = x.sum(0) / n
        var = (x - mean).square().sum(0) / n
        if self.calibrate:
            self.running_mean.copy_(mean.detach())
            self.running_var.copy_(var.detach())
        return (x - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias


def _seq(*mods) -> nn.Sequential:
    return nn.Sequential(*[m if m is not None else nn.Identity() for m in mods])


class Block(nn.Module):
    """conv -> BN -> ReLU (``net.0``, ``net.1``)."""

    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.net = _seq(Conv(k, cin, cout), BN(cout), None)


class Res(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.net = _seq(Conv(27, cin, cout), BN(cout), None, Conv(27, cout, cout), BN(cout))
        self.downsample = _seq(Conv(1, cin, cout), BN(cout)) if cin != cout else None


def _frames_offsets(frames: Sequence[Frame], level: int):
    sizes = [len(f.levels[level].coords) for f in frames]
    return sizes, np.concatenate([[0], np.cumsum(sizes)]).tolist()


class Maps:
    """Batch-flattened maps of every level: rows of frame b at level l start
    at ``off[l][b]``."""

    def __init__(self, frames: Sequence[Frame]):
        nl = len(frames[0].levels)
        self.n, self.off, self.nbr, self.parent = [], [], [], []
        for l in range(nl):
            sizes, off = _frames_offsets(frames, l)
            self.n.append(off[-1])
            self.off.append(off)
            self.nbr.append(torch.cat([torch.where(f.levels[l].nbr >= 0, f.levels[l].nbr + off[b], -1)
                                       for b, f in enumerate(frames)]))
        for l in range(nl - 1):
            self.parent.append(torch.cat([torch.where(f.parent[l] >= 0, f.parent[l] + self.off[l + 1][b], -1)
                                          for b, f in enumerate(frames)]))
        self.delta = []
        for l in range(nl - 1):
            c = torch.cat([f.levels[l].coords for f in frames]) & 1
            self.delta.append((c[:, 0] << 2) | (c[:, 1] << 1) | c[:, 2])


def subm(x: torch.Tensor, w: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    out = x.new_zeros((nbr.shape[0], w.shape[2]))
    for k in range(nbr.shape[1]):
        rows = (nbr[:, k] >= 0).nonzero()[:, 0]
        out = out.index_add(0, rows, x[nbr[rows, k]] @ w[k])
    return out


def down(x: torch.Tensor, w: torch.Tensor, parent: torch.Tensor, delta: torch.Tensor, n_coarse: int) -> torch.Tensor:
    out = x.new_zeros((n_coarse, w.shape[2]))
    for d in range(8):
        rows = ((delta == d) & (parent >= 0)).nonzero()[:, 0]
        out = out.index_add(0, parent[rows], x[rows] @ w[d])
    return out


def up(x: torch.Tensor, w: torch.Tensor, parent: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    out = x.new_zeros((parent.shape[0], w.shape[2]))
    for d in range(8):
        rows = ((delta == d) & (parent >= 0)).nonzero()[:, 0]
        out = out.index_copy(0, rows, x[parent[rows]] @ w[d])
    return out


class MinkUNet(nn.Module):
    def __init__(self, num_classes: int, cs: Sequence[int] = _CS, in_channels: int = 4):
        super().__init__()
        self.stem = _seq(Conv(27, in_channels, cs[0]), BN(cs[0]), None, Conv(27, cs[0], cs[0]), BN(cs[0]), None)
        for i, (cin, cout) in enumerate([(cs[0], cs[1]), (cs[1], cs[2]), (cs[2], cs[3]), (cs[3], cs[4])]):
            self.add_module(f"stage{i + 1}", _seq(Block(8, cin, cin), Res(cin, cout), Res(cout, cout)))
        for j, (cin, cout, skip) in enumerate([(cs[4], cs[5], cs[3]), (cs[5], cs[6], cs[2]),
                                               (cs[6], cs[7], cs[1]), (cs[7], cs[8], cs[0])]):
            self.add_module(f"up{j + 1}", nn.ModuleList([Block(8, cin, cout),
                                                         _seq(Res(cout + skip, cout), Res(cout, cout))]))
        self.classifier = _seq(nn.Linear(cs[8], num_classes))

    # -- blocks ------------------------------------------------------------
    @staticmethod
    def _res(m: Res, x, nbr):
        y = torch.relu(m.net[1](subm(x, m.net[0].kernel, nbr)))
        y = m.net[4](subm(y, m.net[3].kernel, nbr))
        sc = x if m.downsample is None else m.downsample[1](x @ m.downsample[0].kernel[0])
        return torch.relu(y + sc)

    def _stage(self, i, x, mp: Maps):
        blk, r1, r2 = getattr(self, f"stage{i}")
        y = torch.relu(blk.net[1](down(x, blk.net[0].kernel, mp.parent[i - 1], mp.delta[i - 1], mp.n[i])))
        return self._res(r2, self._res(r1, y, mp.nbr[i]), mp.nbr[i])

    def _up(self, j, y, skip, mp: Maps):
        blk, res = getattr(self, f"up{j}")
        l = 4 - j
        y = torch.relu(blk.net[1](up(y, blk.net[0].kernel, mp.parent[l], mp.delta[l])))
        if not self.training:  # the fused eval conv + BN writes 0 where a row has no real tap
            y = y * (mp.parent[l] >= 0)[:, None]
        y = torch.cat([y, skip], dim=-1)
        return self._res(res[1], self._res(res[0], y, mp.nbr[l]), mp.nbr[l])

    def trunk_down(self, feats, mp: Maps):
        x = torch.relu(self.stem[1](subm(feats, self.stem[0].kernel, mp.nbr[0])))
        xs = [torch.relu(self.stem[4](subm(x, self.stem[3].kernel, mp.nbr[0])))]
        for i in range(1, 5):
            xs.append(self._stage(i, xs[-1], mp))
        return xs

    def forward(self, feats, mp: Maps, frames: Sequence[Frame], dropout_seeds=None):
        xs = self.trunk_down(feats, mp)
        y = xs[4]
        for j in range(1, 5):
            y = self._up(j, y, xs[4 - j], mp)
        return self.classifier(y)


class PointTransform(nn.Sequential):
    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Linear(cin, cout), BN(cout), nn.Identity())

    def forward(self, x):
        return torch.relu(self[1](self[0](x)))


def _ancestors(mp: Maps, level: int) -> torch.Tensor:
    """Each level-0 row's ancestor row at ``level`` (-1 where a cap dropped one)."""
    cur = torch.arange(mp.n[0], device=mp.nbr[0].device)
    for l in range(level):
        ext = torch.cat([mp.parent[l], mp.parent[l].new_full((1,), -1)])
        cur = ext[torch.where(cur >= 0, cur, mp.n[l])]
    return cur


_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def trilinear(feats_l: torch.Tensor, coords0: torch.Tensor, anc: torch.Tensor, nbr_l: torch.Tensor, level: int):
    """Sum over the 8 corners floor(c / 2^l) + d of w_d * feats_l[corner],
    w_d = prod(d ? u : 1 - u), u = frac(c / 2^l); corners looked up from the
    ancestor voxel (none where the ancestor was dropped)."""
    s = 1 << level
    u = (coords0 & (s - 1)).to(torch.float32) / float(s)
    out = feats_l.new_zeros((coords0.shape[0], feats_l.shape[1]))
    has = anc >= 0
    for dx, dy, dz in _CORNERS:
        tap = (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)
        corner = torch.where(has, nbr_l[anc.clamp_min(0), tap], -1)
        w = torch.ones_like(u[:, 0])
        for axis, dd in enumerate((dx, dy, dz)):
            w = w * (u[:, axis] if dd else 1.0 - u[:, axis])
        rows = (corner >= 0).nonzero()[:, 0]
        out = out.index_add(0, rows, w[rows, None] * feats_l[corner[rows]])
    return out


def average(x: torch.Tensor, anc: torch.Tensor, n_l: int) -> torch.Tensor:
    rows = (anc >= 0).nonzero()[:, 0]
    sums = x.new_zeros((n_l, x.shape[1])).index_add(0, anc[rows], x[rows])
    counts = torch.zeros(n_l, device=x.device).index_add(0, anc[rows], torch.ones(len(rows), device=x.device))
    return sums / counts.clamp_min(1.0)[:, None]


def dropout(x: torch.Tensor, frames_rows: List[int], seeds: Sequence[int], site: int, cap: int, rate: float = 0.3):
    """Per-frame masks over a frame's padded rows ``[cap, c]``: a generator on
    ``x``'s device seeded from ``SeedSequence([seed, site])`` draws
    ``rand(cap, c) < 1 - rate``; the frame's real rows are its first rows."""
    keep = 1.0 - rate
    parts, start = [], 0
    for n, seed in zip(frames_rows, seeds):
        mixed = np.random.SeedSequence([int(seed), site]).generate_state(1, np.uint64)[0]
        g = torch.Generator(device=x.device).manual_seed(int(mixed) & (2**63 - 1))
        mask = torch.rand((cap, x.shape[1]), generator=g, device=x.device)[:n] < keep
        parts.append(torch.where(mask, x[start:start + n] / keep, 0.0))
        start += n
    return torch.cat(parts)


class SPVCNN(MinkUNet):
    def __init__(self, num_classes: int, cs: Sequence[int] = _CS, in_channels: int = 4):
        super().__init__(num_classes, cs, in_channels)
        self.point_transforms = nn.ModuleList(
            [PointTransform(cs[0], cs[4]), PointTransform(cs[4], cs[6]), PointTransform(cs[6], cs[8])])

    def forward(self, feats, mp: Maps, frames: Sequence[Frame], dropout_seeds=None, caps=None):
        coords0 = torch.cat([f.levels[0].coords for f in frames])
        anc = {l: _ancestors(mp, l) for l in (2, 4)}
        rows4 = [len(f.levels[4].coords) for f in frames]
        rows2 = [len(f.levels[2].coords) for f in frames]
        x0, x1, x2, x3, x4 = self.trunk_down(feats, mp)
        z1 = trilinear(x4, coords0, anc[4], mp.nbr[4], 4) + self.point_transforms[0](x0)
        y1 = average(z1, anc[4], mp.n[4])
        if self.training:
            y1 = dropout(y1, rows4, dropout_seeds, 1, caps[4])
        y1 = self._up(1, y1, x3, mp)
        y2 = self._up(2, y1, x2, mp)
        z2 = trilinear(y2, coords0, anc[2], mp.nbr[2], 2) + self.point_transforms[1](z1)
        y3 = average(z2, anc[2], mp.n[2])
        if self.training:
            y3 = dropout(y3, rows2, dropout_seeds, 2, caps[2])
        y3 = self._up(3, y3, x1, mp)
        y4 = self._up(4, y3, x0, mp)
        return self.classifier(y4 + self.point_transforms[2](z2))


def build(spvcnn: bool, num_classes: int, cs: Sequence[int], in_channels: int) -> MinkUNet:
    return (SPVCNN if spvcnn else MinkUNet)(num_classes, cs, in_channels)


def seeded_weights(model: nn.Module, seed: int, device) -> dict:
    """Initial weights from ``seed`` on ``device``, drawn in one call: conv
    kernels, Linear weights and biases uniform within the torch default
    fan-in bound 1/sqrt(fan_in); BN scale 1 and shift 0."""
    drawn = []  # (name, shape, fan_in) in module order
    out = {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, Conv):
            drawn.append((pre + "kernel", m.kernel.shape, m.kernel.shape[0] * m.kernel.shape[1]))
        elif isinstance(m, nn.Linear):
            drawn += [(pre + "weight", m.weight.shape, m.in_features), (pre + "bias", m.bias.shape, m.in_features)]
        elif isinstance(m, BN):
            out[pre + "weight"] = torch.ones(m.weight.shape, device=device)
            out[pre + "bias"] = torch.zeros(m.bias.shape, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(math.prod(s) for _, s, _ in drawn), generator=g, device=device) * 2.0 - 1.0
    start = 0
    for name, shape, fan_in in drawn:
        n = math.prod(shape)
        out[name] = flat[start: start + n].view(shape) / math.sqrt(fan_in)
        start += n
    return out
