"""Plain PyTorch Point Transformer V3 (Wu et al., CVPR 2024; Pointcept
``point_transformer_v3m1_base.py`` at its SemanticKITTI settings) over one
batch of :class:`data.Frame` tables, in train mode, f32 with TF32 off, and
its first train steps.

Written without any code of the program: rows are the frames' voxels one
frame after another (``model.Maps``), each sparse conv a loop over its taps
(``model.subm``) over this module's own maps (the kernel-5 stem's 125 taps
here, kernel 3 from ``model.Maps``), the curve codes computed bit by bit
(z: bits i of x, y, z at 3i + 2, 3i + 1, 3i; Hilbert: Pointcept's
``hilbert.encode``, the transform on arrays of bits and the Gray code undone
over the interleaved bits), a coarse voxel's code its children's >> 3 written
through the parent map, patches padded with Pointcept's own arithmetic
(``get_padding_and_inverse``) and attention as explicit products and a
softmax over blocks of patches, recomputed in the backward
(``torch.utils.checkpoint``) so the scores are never all held.

Randomness, as the program draws it: after a step's augmentation, one seed
per frame (``randint(0, 2**62)``) and one for the step; the four orders of
each level permuted by ``randperm(4)`` from a CPU generator seeded with the
step's seed, level after level; drop path per token, frame b's mask
``rand(cap_l) < 1 - rate`` on the device from ``SeedSequence([seed_b,
site])``, site 2 x block (+ 1 for the MLP), blocks numbered encoder first
and the decoder from its coarsest stage.

``fault`` plants one of the faults the check must catch, in the reference
put in the program's place: ``tf32`` (TF32 on in the model), ``bf16_qkv``
(q, k and v rounded to bf16), ``zero_pad`` (the last patch padded with zero
tokens), ``no_shuffle`` (the orders as written), ``frozen`` (no update).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lidal_bench.reference import data as rdata
from lidal_bench.reference.model import Maps, subm
from lidal_bench.reference.train import loss_of, prepare, tf32

ENC = ((32, 2, 2), (64, 2, 4), (128, 2, 8), (256, 6, 16), (512, 2, 32))  # channels, depth, heads
DEC = ((64, 2, 4), (64, 2, 4), (128, 2, 8), (256, 2, 16))
PATCH = 1024
DROP_PATH = 0.3
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
OFFSETS5 = torch.tensor([(a, b, c) for a in range(-2, 3) for b in range(-2, 3) for c in range(-2, 3)])
ATTN_BLOCK = 32  # patches a block of the explicit attention


# -- maps and codes ---------------------------------------------------------
def stem_map(frames: Sequence[rdata.Frame], mp: Maps) -> torch.Tensor:
    """[n0, 125] level-0 rows of coords + OFFSETS5[k] (x-major), -1 where absent."""
    parts = []
    for b, f in enumerate(frames):
        c = f.levels[0].coords
        keys = rdata.pack(c)
        nbr = rdata._lookup(keys, rdata.pack(c[:, None, :] + OFFSETS5.to(c.device)[None]))
        parts.append(torch.where(nbr >= 0, nbr + mp.off[0][b], -1))
    return torch.cat(parts)


def _bits(v: torch.Tensor, depth: int) -> torch.Tensor:
    """[n, depth] bits of v, most significant first."""
    return torch.stack([(v >> (depth - 1 - i)) & 1 for i in range(depth)], 1)


def z_code(c: torch.Tensor, depth: int) -> torch.Tensor:
    out = torch.zeros(len(c), dtype=torch.int64, device=c.device)
    for i in range(depth):
        out = out | (((c[:, 0] >> i) & 1) << (3 * i + 2)) | (((c[:, 1] >> i) & 1) << (3 * i + 1)) \
            | (((c[:, 2] >> i) & 1) << (3 * i))
    return out


def hilbert_code(c: torch.Tensor, depth: int) -> torch.Tensor:
    """Pointcept's ``hilbert.encode(c, 3, depth)``."""
    gray = torch.stack([_bits(c[:, d], depth) for d in range(3)], 1).bool()  # [n, dim, bit]
    for bit in range(depth):
        for dim in range(3):
            mask = gray[:, dim, bit]
            gray[:, 0, bit + 1:] = gray[:, 0, bit + 1:] ^ mask[:, None]
            to_flip = (~mask[:, None]) & (gray[:, 0, bit + 1:] ^ gray[:, dim, bit + 1:])
            gray[:, dim, bit + 1:] = gray[:, dim, bit + 1:] ^ to_flip
            gray[:, 0, bit + 1:] = gray[:, 0, bit + 1:] ^ to_flip
    flat = gray.transpose(1, 2).reshape(len(c), 3 * depth)  # the bits interleaved, x first
    binary = torch.cumsum(flat.long(), 1) % 2  # Gray code undone: each bit the parity of those before it
    weights = torch.tensor([1 << (3 * depth - 1 - i) for i in range(3 * depth)], device=c.device)
    return (binary * weights).sum(1)


def curve(c: torch.Tensor, depth: int, order: str) -> torch.Tensor:
    c = c.long()
    if order.endswith("-trans"):
        c = c[:, [1, 0, 2]]
    return z_code(c, depth) if order.startswith("z") else hilbert_code(c, depth)


class Serial:
    """Per level: the rows' order along each of the four curves (frame by
    frame), the permutation of the orders and the padding."""

    def __init__(self, frames: Sequence[rdata.Frame], mp: Maps, perms: List[List[int]], zero_pad: bool = False):
        nl = len(frames[0].levels)
        coords0 = torch.cat([f.levels[0].coords for f in frames])
        depth = int(coords0.max() + 1).bit_length()
        codes = [torch.stack([curve(coords0, depth, o) for o in ORDERS])]
        for l in range(nl - 1):
            par = mp.parent[l]
            keep = par >= 0
            nxt = torch.zeros((len(ORDERS), mp.n[l + 1]), dtype=torch.int64, device=coords0.device)
            nxt[:, par[keep]] = codes[-1][:, keep] >> 3  # every child writes its parent's code
            codes.append(nxt)
        self.levels = []
        for l in range(nl):
            sizes = [len(f.levels[l].coords) for f in frames]
            frame = torch.repeat_interleave(torch.arange(len(frames), device=coords0.device),
                                            torch.tensor(sizes, device=coords0.device))
            key = (frame[None] << (3 * depth)) | codes[l]  # Pointcept's batch << 3 x depth | code
            order = torch.argsort(key, dim=1)
            pad, unpad, k = padding(sizes, zero_pad)
            self.levels.append({"order": order[perms[l]], "pad": pad, "unpad": unpad, "k": k})


def padding(sizes: Sequence[int], zero_pad: bool):
    """Pointcept's ``get_padding_and_inverse`` over frames of ``sizes`` rows:
    ``pad`` [padded] the sorted place each slot reads (-1: a zero token under
    ``zero_pad``), ``unpad`` [n] each sorted place's slot, and the patch size."""
    k = min([PATCH] + [n for n in sizes if n > 0])
    bincount = torch.tensor(sizes)
    bincount_pad = (bincount + k - 1) // k * k
    mask_pad = bincount > k
    bincount_pad = ~mask_pad * bincount + mask_pad * bincount_pad
    offset = F.pad(torch.cumsum(bincount, 0), (1, 0))
    offset_pad = F.pad(torch.cumsum(bincount_pad, 0), (1, 0))
    pad = torch.arange(int(offset_pad[-1]))
    unpad = torch.arange(int(offset[-1]))
    for i in range(len(sizes)):
        unpad[offset[i]: offset[i + 1]] += offset_pad[i] - offset[i]
        end = int(offset_pad[i + 1])
        lo = end - k + int(bincount[i] % k)
        if bincount[i] != bincount_pad[i]:
            pad[lo:end] = pad[lo - k:end - k]
        pad[offset_pad[i]:end] -= offset_pad[i] - offset[i]
        if zero_pad and bincount[i] != bincount_pad[i]:
            pad[lo:end] = -1
    return pad, unpad, k


# -- the model ----------------------------------------------------------------
class Conv(nn.Module):
    def __init__(self, k: int, cin: int, cout: int, bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x, nbr):
        y = subm(x, self.kernel, nbr)
        return y if self.bias is None else y + self.bias


class BN(nn.Module):
    """Train mode, batch statistics over the rows, eps 1e-3."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        n = max(x.shape[0], 1)
        mean = x.sum(0) / n
        var = (x - mean).square().sum(0) / n
        return (x - mean) * torch.rsqrt(var + 1e-3) * self.weight + self.bias


def _attend(q, k, v, scale):
    attn = torch.softmax((q * scale) @ k.transpose(-2, -1), dim=-1)
    return attn @ v


class Attention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x, lv: Dict, slot: int, bf16: bool):
        n, c = x.shape
        h, k = self.heads, lv["k"]
        order, pad = lv["order"][slot], lv["pad"].to(x.device)
        qkv = self.qkv(x)[order]
        qkv = torch.cat([qkv, qkv.new_zeros((1, 3 * c))])[torch.where(pad >= 0, pad, n)]
        q, kk, v = qkv.reshape(-1, k, 3, h, c // h).permute(2, 0, 3, 1, 4).unbind(0)
        if bf16:
            q, kk, v = (t.to(torch.bfloat16).float() for t in (q, kk, v))
        scale = (c // h) ** -0.5
        outs = [checkpoint(_attend, q[i:i + ATTN_BLOCK], kk[i:i + ATTN_BLOCK], v[i:i + ATTN_BLOCK], scale,
                           use_reentrant=False) for i in range(0, q.shape[0], ATTN_BLOCK)]
        feat = torch.cat(outs).transpose(1, 2).reshape(-1, c)
        inverse = torch.empty_like(order)
        inverse[order] = torch.arange(n, device=x.device)
        return self.proj(feat[lv["unpad"].to(x.device)[inverse]])


class Block(nn.Module):
    def __init__(self, c, heads, drop, slot, site):
        super().__init__()
        self.drop, self.slot, self.site = drop, slot, site
        self.cpe = nn.ModuleDict({"conv": Conv(27, c, c, True), "linear": nn.Linear(c, c), "norm": nn.LayerNorm(c)})
        self.norm1 = nn.LayerNorm(c)
        self.attn = Attention(c, heads)
        self.norm2 = nn.LayerNorm(c)
        self.mlp = nn.Sequential(nn.Linear(c, 4 * c), nn.GELU(), nn.Linear(4 * c, c))

    def forward(self, x, nbr, lv, ctx):
        x = x + self.cpe["norm"](self.cpe["linear"](self.cpe["conv"](x, nbr)))
        x = x + ctx.drop(self.attn(self.norm1(x), lv, self.slot, ctx.bf16), self.drop, 2 * self.site)
        return x + ctx.drop(self.mlp(self.norm2(x)), self.drop, 2 * self.site + 1)


class Pooling(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.norm = BN(cout)

    def forward(self, x, parent, n_coarse):
        h = self.proj(x)
        keep = (parent >= 0).nonzero()[:, 0]
        idx = parent[keep][:, None].expand(-1, h.shape[1])
        y = h.new_full((n_coarse, h.shape[1]), -math.inf).scatter_reduce(0, idx, h[keep], "amax")
        return F.gelu(self.norm(y))


class Unpooling(nn.Module):
    def __init__(self, cin, cskip, cout):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.proj_norm = BN(cout)
        self.proj_skip = nn.Linear(cskip, cout)
        self.skip_norm = BN(cout)

    def forward(self, x, skip, parent):
        c = F.gelu(self.proj_norm(self.proj(x)))
        s = F.gelu(self.skip_norm(self.proj_skip(skip)))
        up = torch.cat([c, c.new_zeros((1, c.shape[1]))])[torch.where(parent >= 0, parent, len(c))]
        return s + up


class Stage(nn.Module):
    def __init__(self, entry, c, depth, heads, drops, site):
        super().__init__()
        if entry is not None:
            self.add_module("down" if isinstance(entry, Pooling) else "up", entry)
        self.blocks = nn.ModuleList([Block(c, heads, drops[i], i % 4, site + i) for i in range(depth)])


class Context:
    """A forward's draws and faults."""

    def __init__(self, frames_rows: List[List[int]], caps, seeds, bf16: bool):
        self.rows, self.caps, self.seeds, self.bf16 = frames_rows, caps, seeds, bf16
        self.level = 0

    def drop(self, x, rate, site):
        if self.seeds is None or rate == 0.0:
            return x
        keep = 1.0 - rate
        parts, start = [], 0
        for n, seed in zip(self.rows[self.level], self.seeds):
            mixed = np.random.SeedSequence([int(seed), site]).generate_state(1, np.uint64)[0]
            g = torch.Generator(device=x.device).manual_seed(int(mixed) & (2**63 - 1))
            mask = torch.rand(self.caps[self.level], generator=g, device=x.device)[:n] < keep
            parts.append(torch.where(mask[:, None], x[start:start + n] / keep, 0.0))
            start += n
        return torch.cat(parts)


class PTv3(nn.Module):
    def __init__(self, num_classes: int = 19, in_channels: int = 4):
        super().__init__()
        self.embedding = nn.ModuleDict({"conv": Conv(125, in_channels, ENC[0][0], False), "norm": BN(ENC[0][0])})
        enc_drop = torch.linspace(0, DROP_PATH, sum(d for _, d, _ in ENC), device="cpu").tolist()
        self.enc = nn.ModuleList()
        site = start = 0
        for s, (c, depth, heads) in enumerate(ENC):
            entry = Pooling(ENC[s - 1][0], c) if s > 0 else None
            self.enc.append(Stage(entry, c, depth, heads, enc_drop[start:start + depth], site))
            start += depth
            site += depth
        dec_drop = torch.linspace(0, DROP_PATH, sum(d for _, d, _ in DEC), device="cpu").tolist()
        stages = {}
        for s in (3, 2, 1, 0):
            c, depth, heads = DEC[s]
            cin = DEC[s + 1][0] if s + 1 < len(DEC) else ENC[-1][0]
            first = sum(d for _, d, _ in DEC[:s])
            stages[s] = Stage(Unpooling(cin, ENC[s][0], c), c, depth, heads, dec_drop[first:first + depth][::-1], site)
            site += depth
        self.dec = nn.ModuleList([stages[s] for s in range(4)])
        self.head = nn.Linear(DEC[0][0], num_classes)

    def forward(self, feats, mp: Maps, nbr5, serial: Serial, ctx: Context):
        x = F.gelu(self.embedding["norm"](self.embedding["conv"](feats, nbr5)))
        skips = []
        for s, stage in enumerate(self.enc):
            ctx.level = s
            if s > 0:
                x = stage.down(x, mp.parent[s - 1], mp.n[s])
            for blk in stage.blocks:
                x = blk(x, mp.nbr[s], serial.levels[s], ctx)
            skips.append(x)
        for s in (3, 2, 1, 0):
            ctx.level = s
            stage = self.dec[s]
            x = stage.up(x, skips[s], mp.parent[s])
            for blk in stage.blocks:
                x = blk(x, mp.nbr[s], serial.levels[s], ctx)
        return self.head(x)


def seeded_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial weights from ``seed`` on ``device``, drawn in one call in module
    order: conv kernels and biases uniform within 1/sqrt(taps x cin), Linear
    weights and biases within 1/sqrt(fan_in); norms' scale 1 and shift 0."""
    drawn, out = [], {}
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, Conv):
            fan = m.kernel.shape[0] * m.kernel.shape[1]
            drawn.append((pre + "kernel", m.kernel.shape, fan))
            if m.bias is not None:
                drawn.append((pre + "bias", m.bias.shape, fan))
        elif isinstance(m, nn.Linear):
            drawn += [(pre + "weight", m.weight.shape, m.in_features), (pre + "bias", m.bias.shape, m.in_features)]
        elif isinstance(m, (BN, nn.LayerNorm)):
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


def order_perms(seed: Optional[int], levels: int) -> List[List[int]]:
    if seed is None:
        return [[0, 1, 2, 3]] * levels
    g = torch.Generator().manual_seed(int(seed))
    return [torch.randperm(4, generator=g).tolist() for _ in range(levels)]


def run_steps(batches: Sequence[Sequence[str]], weights: Dict[str, torch.Tensor], seed: int, cfg: Dict, device,
              steps: int, fault: Optional[str] = None, keep_first: bool = False) -> Dict:
    """Follow the program's first ``steps`` steps, as ``train.run_steps`` does
    for the U-Nets: ``{"loss", "grad1", "delta", "counts"}``; with
    ``keep_first`` also the first step's logits and gradients (``"first"``)."""
    model = PTv3(cfg["num_classes"], cfg["in_channels"]).to(device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    model.train()
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator().manual_seed(seed)
    out = {"loss": [], "grad1": {}, "delta": {}, "counts": []}
    b = cfg["batch_size"]
    for k in range(steps):
        draws = rdata.draw_augment(gen, b)
        seeds = torch.randint(0, 2**62, (b,), generator=gen).tolist()
        order_seed = int(torch.randint(0, 2**62, (1,), generator=gen))
        feats, labels, frames = prepare(batches[k], draws, cfg, device)
        out["counts"].append({"what": f"checked batch {k + 1}",
                              "voxels": np.sum([rdata.level_counts(fr)[0] for fr in frames], 0).tolist(),
                              "overflow": np.sum([fr.overflow for fr in frames], 0).tolist()})
        with tf32(fault == "tf32"):
            mp = Maps(frames)
            perms = order_perms(None if fault == "no_shuffle" else order_seed, len(frames[0].levels))
            serial = Serial(frames, mp, perms, zero_pad=fault == "zero_pad")
            rows = [[len(f.levels[l].coords) for f in frames] for l in range(len(frames[0].levels))]
            ctx = Context(rows, cfg["level_caps"], seeds, fault == "bf16_qkv")
            logits = model(feats, mp, stem_map(frames, mp), serial, ctx)
            loss = loss_of(logits, labels)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        if k == 0:
            out["grad1"] = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
            if keep_first:
                out["first"] = {"logits": logits.detach(), "loss": float(loss.detach()),
                                "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}
        if fault != "frozen":
            opt.step()
        out["loss"].append(float(loss.detach()))
        del logits, loss, mp, feats, serial
    out["delta"] = {n: float((p.detach() - w0[n]).norm()) for n, p in model.named_parameters()}
    return out
