"""Point Transformer V3 (Wu et al., CVPR 2024, arXiv 2312.10035) over the
port's voxel levels: Pointcept's ``point_transformer_v3m1_base.py`` at its
SemanticKITTI settings (``configs/semantic_kitti/semseg-pt-v3m1-0-base.py``).

* Input: the level-0 voxels and their 4 features; 19 classes at 0.05 m.
* Serialization (span ``ptv3.serialize``, once a forward): the codes of the
  four orders z, z-trans, hilbert, hilbert-trans on level 0, codes >> 3 on
  each coarser level (``ops/serialize``), each order's sort and inverse and
  each level's patches (``ops/patch_attention``).  In training the four
  orders are permuted at every level with draws from the step's seed; in
  eval they stay as written (Pointcept also shuffles in eval: a fixed order
  keeps multi-view inference deterministic).
* Embedding: a kernel-5 submanifold conv (4 -> 32, no bias; 125 taps, run as
  groups of the 27-tap kernel, ``ops/conv.subm_conv_wide``) -> BN -> GELU.
* Encoder: channels (32, 64, 128, 256, 512), depths (2, 2, 2, 6, 2), heads
  (2, 4, 8, 16, 32); stages 1-4 start with a pooling (span ``ptv3.pool``):
  Linear -> max over each parent's children (``DownPlan.child``, a gather)
  -> BN -> GELU.  The port's coarse levels are PTv3's pooling clusters.
* Decoder: channels (64, 64, 128, 256), two blocks a stage, heads (4, 4, 8,
  16), each stage after an unpooling (span ``ptv3.unpool``):
  GELU(BN(Linear(skip))) + GELU(BN(Linear(coarse)))[parent].
* Block (block i of a stage takes order slot i mod 4): ``x += LN(Linear(
  SubMConv3(x) + bias))``; ``x += DropPath(Attn(LN(x)))``; ``x +=
  DropPath(MLP(LN(x)))``, MLP ``Linear(C, 4C) -> GELU -> Linear(4C, C)``.
* Attn (span ``ptv3.attention``): ``qkv = Linear(C, 3C)`` permuted to the
  order, patches of ``min(1024, the smallest frame's voxels)`` tokens padded
  as Pointcept pads them, softmax attention with head dimension 16
  (``ops/patch_attention.patch_attention``), un-padded, the inverse order,
  ``proj = Linear(C, C)``.  Counters: ``ptv3.patches`` and
  ``ptv3.pad_tokens`` (duplicated tokens), added by every attention call.
* Drop path (stochastic depth): rates ``linspace(0, 0.3)`` over the
  encoder's 14 blocks and over the decoder's 8, reversed within each decoder
  stage; per token, each frame's mask drawn from that frame's seed as
  :class:`layers.PerFrameDropout` draws (site = 2 x block + 0 for the
  attention, 1 for the MLP, blocks numbered encoder first).
* Head: Linear(64, 19).  BNs are :class:`layers.MaskedBatchNorm` with eps
  1e-3 and momentum 0.01 (Pointcept's ``BatchNorm1d``); LayerNorm eps 1e-5.

Layout: every level is ``[B, cap, C]`` as in MinkUNet; rows past a frame's
valid voxels are zeroed after each block and never read by a conv, the
attention, a pooling or a BN.  f32 throughout (Pointcept casts qkv to fp16
for flash attention).  The forward reads the levels' voxel counts and the
largest level-0 coordinate on the host once (the patch sizes and the curve
depth are shapes), and builds the stem's kernel-5 map of level 0 itself
(``kernel_map.build_subm5_nbr_batched``; the U-Nets never build it).
``forward(feats, plan, draws)`` returns
``(logits [B, cap0, classes], feats [B, cap0, 64])``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lidal_tpu_torch.models.layers import MaskedBatchNorm
from lidal_tpu_torch.ops import patch_attention as pa, serialize
from lidal_tpu_torch.ops.conv import subm_conv_batched
from lidal_tpu_torch.ops.kernel_map import K3, K5, DownPlan, LevelPlan, UNetPlan, build_subm5_nbr_batched
from lidal_tpu_torch.utils import profiling

ENC_CHANNELS = (32, 64, 128, 256, 512)
ENC_DEPTHS = (2, 2, 2, 6, 2)
ENC_HEADS = (2, 4, 8, 16, 32)
DEC_CHANNELS = (64, 64, 128, 256)
DEC_DEPTHS = (2, 2, 2, 2)
DEC_HEADS = (4, 4, 8, 16)
PATCH = 1024
DROP_PATH = 0.3
MLP_RATIO = 4


class StepDraws(NamedTuple):
    """A train step's draws: one seed per frame (drop path), one for the step
    (the order shuffle)."""

    frame_seeds: Sequence[int]
    order_seed: int


class BatchNorm(MaskedBatchNorm):
    """Pointcept's ``BatchNorm1d(eps=1e-3, momentum=0.01)`` over the valid rows."""

    momentum = 0.01

    def __init__(self, features: int):
        super().__init__(features, eps=1e-3)


class SubMConv(nn.Module):
    """A submanifold conv ``kernel [K, cin, cout]`` (x-major taps, the map's
    columns), with an optional bias; Pointcept's spconv init bound
    1/sqrt(K * cin) for both.  ``order`` is the map's row order (None for
    the kernel-5 stem, whose groups of taps walk none)."""

    def __init__(self, taps: int, cin: int, cout: int, bias: bool):
        super().__init__()
        bound = 1.0 / math.sqrt(taps * cin)
        self.kernel = nn.Parameter(torch.empty(taps, cin, cout).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(cout).uniform_(-bound, bound)) if bias else None

    def forward(self, x: torch.Tensor, nbr: torch.Tensor, order: Optional[torch.Tensor]) -> torch.Tensor:
        y = subm_conv_batched(x, self.kernel, nbr, order=order)
        return y if self.bias is None else y + self.bias


class Level(NamedTuple):
    """One level's serialization: its patches and, per block slot, the index
    of the order the slot takes."""

    layout: pa.PatchLayout
    slots: List[pa.OrderIndex]


def _serialize(plan: UNetPlan, draws: Optional[StepDraws]) -> List[Level]:
    levels = plan.levels
    maxc = torch.where(levels[0].valid[..., None], levels[0].coords, 0).amax().long().reshape(1)
    host = torch.cat([maxc] + [lv.num_valid.long() for lv in levels]).tolist()
    depth = serialize.depth_of(host[0])
    b = levels[0].valid.shape[0]
    counts = [host[1 + l * b: 1 + (l + 1) * b] for l in range(len(levels))]
    codes = serialize.level_codes(levels[0].coords, levels[0].valid, plan.downs,
                                  [lv.valid for lv in levels[1:]], depth)
    perms = serialize.order_perms(draws.order_seed, len(levels)) if draws is not None else \
        [list(range(len(serialize.ORDERS)))] * len(levels)
    out = []
    for l, (lv, cs, n, perm) in enumerate(zip(levels, codes, counts, perms)):
        layout = pa.patch_layout(n, lv.valid.shape[1], PATCH, lv.valid.device)
        used = min(len(perm), max(ENC_DEPTHS[l], DEC_DEPTHS[l] if l < len(DEC_DEPTHS) else 0))
        slots = [pa.order_index(layout, *serialize.sort_orders(cs[o]), lv.valid) for o in perm[:used]]
        out.append(Level(layout, slots))
    return out


def drop_path(branch: torch.Tensor, rate: float, draws: Optional[StepDraws], site: int) -> torch.Tensor:
    """``branch`` [B, cap, C] with each token kept with probability ``1 - rate``
    (and scaled by its inverse), frame b's mask ``rand(cap) < 1 - rate`` from a
    generator on the tensor's device seeded from ``SeedSequence([seed_b, site])``;
    the identity in eval or at rate 0."""
    if draws is None or rate == 0.0:
        return branch
    keep = 1.0 - rate
    masks = []
    for seed in draws.frame_seeds:
        mixed = np.random.SeedSequence([int(seed), site]).generate_state(1, np.uint64)[0]
        g = torch.Generator(device=branch.device).manual_seed(int(mixed) & (2**63 - 1))
        masks.append(torch.rand(branch.shape[1], generator=g, device=branch.device) < keep)
    return torch.where(torch.stack(masks)[..., None], branch / keep, 0.0)


class Attention(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, level: Level, slot: int) -> torch.Tensor:
        b, cap, c = x.shape
        lay, idx = level.layout, level.slots[slot]
        with profiling.span("ptv3.attention"):
            if lay.tokens == 0:
                return self.proj(torch.zeros_like(x))
            profiling.count("ptv3.patches", lay.patches)
            profiling.count("ptv3.pad_tokens", lay.pad_tokens)
            qkv = pa.to_slots(self.qkv(x).reshape(b * cap, 3 * c), idx)
            h, d = self.heads, c // self.heads
            q, k, v = (t.contiguous() for t in qkv.view(lay.patches, lay.k, 3, h, d).permute(2, 0, 3, 1, 4))
            o = pa.patch_attention(q, k, v).transpose(1, 2).reshape(lay.tokens, c)
            o = pa.from_slots(o, idx).view(b, cap, c)
            return self.proj(o)


class Block(nn.Module):
    def __init__(self, c: int, heads: int, drop: float, slot: int, site: int):
        super().__init__()
        self.drop, self.slot, self.site = drop, slot, site
        self.cpe = nn.ModuleDict({"conv": SubMConv(K3, c, c, bias=True), "linear": nn.Linear(c, c),
                                  "norm": nn.LayerNorm(c)})
        self.norm1 = nn.LayerNorm(c)
        self.attn = Attention(c, heads)
        self.norm2 = nn.LayerNorm(c)
        self.mlp = nn.Sequential(nn.Linear(c, MLP_RATIO * c), nn.GELU(), nn.Linear(MLP_RATIO * c, c))

    def forward(self, x, lp: LevelPlan, level: Level, draws: Optional[StepDraws]):
        x = x + self.cpe["norm"](self.cpe["linear"](self.cpe["conv"](x, lp.nbr3, lp.order)))
        x = x + drop_path(self.attn(self.norm1(x), level, self.slot), self.drop, draws, 2 * self.site)
        x = x + drop_path(self.mlp(self.norm2(x)), self.drop, draws, 2 * self.site + 1)
        return x * lp.valid[..., None]


class _ChildMax(torch.autograd.Function):
    """h [B, cap_fine, C] -> [B, cap_coarse, C]: the max over each coarse row's
    children (``child``, sentinel cap_fine; -inf where a row has none).  The
    backward is a gather too: a fine row takes its parent's gradient in the
    channels where it held the max (the first child of a tie)."""

    @staticmethod
    def forward(ctx, h, child, parent, pdelta):
        b, nc, kk = child.shape
        c = h.shape[2]
        he = F.pad(h, (0, 0, 0, 1), value=-math.inf)
        y, arg = he.gather(1, child.long().reshape(b, nc * kk, 1).expand(-1, -1, c)).view(b, nc, kk, c).max(dim=2)
        ctx.save_for_backward(arg, parent, pdelta)
        return y

    @staticmethod
    def backward(ctx, dy):
        arg, parent, pdelta = ctx.saved_tensors
        rows = parent.long()[..., None].expand(-1, -1, dy.shape[2])
        held = F.pad(arg, (0, 0, 0, 1), value=-1).gather(1, rows) == pdelta.long()[..., None]
        return torch.where(held, F.pad(dy, (0, 0, 0, 1)).gather(1, rows), 0.0), None, None, None


class _ParentGather(torch.autograd.Function):
    """c [B, cap_coarse, C] -> [B, cap_fine, C]: each fine row its parent's
    row (``parent``, sentinel cap_coarse: 0); the backward sums each coarse
    row's children (``child``) in tap order, a gather."""

    @staticmethod
    def forward(ctx, c, parent, child):
        ctx.save_for_backward(child)
        return F.pad(c, (0, 0, 0, 1)).gather(1, parent.long()[..., None].expand(-1, -1, c.shape[2]))

    @staticmethod
    def backward(ctx, dy):
        (child,) = ctx.saved_tensors
        b, nc, kk = child.shape
        rows = child.long().reshape(b, nc * kk, 1).expand(-1, -1, dy.shape[2])
        return F.pad(dy, (0, 0, 0, 1)).gather(1, rows).view(b, nc, kk, -1).sum(dim=2), None, None


class Pooling(nn.Module):
    """Linear -> the max over each coarse voxel's children -> BN -> GELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.norm = BatchNorm(cout)

    def forward(self, x: torch.Tensor, down: DownPlan, valid: torch.Tensor) -> torch.Tensor:
        with profiling.span("ptv3.pool"):
            y = _ChildMax.apply(self.proj(x), down.child, down.parent, down.pdelta)
            y = torch.where(valid[..., None], y, 0.0)
            return F.gelu(self.norm(y, valid))


class Unpooling(nn.Module):
    """GELU(BN(Linear(skip))) + GELU(BN(Linear(coarse)))[parent]."""

    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.proj_norm = BatchNorm(cout)
        self.proj_skip = nn.Linear(cskip, cout)
        self.skip_norm = BatchNorm(cout)

    def forward(self, x, skip, down: DownPlan, valid_coarse, valid_fine) -> torch.Tensor:
        with profiling.span("ptv3.unpool"):
            c = F.gelu(self.proj_norm(self.proj(x), valid_coarse))
            s = F.gelu(self.skip_norm(self.proj_skip(skip), valid_fine))
            return (s + _ParentGather.apply(c, down.parent, down.child)) * valid_fine[..., None]


class Stage(nn.Module):
    def __init__(self, entry: Optional[nn.Module], c: int, depth: int, heads: int, drops: Sequence[float],
                 first_site: int):
        super().__init__()
        if entry is not None:
            self.add_module("down" if isinstance(entry, Pooling) else "up", entry)
        self.blocks = nn.ModuleList([Block(c, heads, drops[i], i % len(serialize.ORDERS), first_site + i)
                                     for i in range(depth)])

    def run_blocks(self, x, lp: LevelPlan, level: Level, draws):
        for blk in self.blocks:
            x = blk(x, lp, level, draws)
        return x


class PTv3(nn.Module):
    def __init__(self, num_classes: int = 19, in_channels: int = 4):
        super().__init__()
        self.embedding = nn.ModuleDict({"conv": SubMConv(K5, in_channels, ENC_CHANNELS[0], bias=False),
                                        "norm": BatchNorm(ENC_CHANNELS[0])})
        enc_drop = torch.linspace(0, DROP_PATH, sum(ENC_DEPTHS), device="cpu").tolist()
        self.enc = nn.ModuleList()
        site = 0
        for s, (c, depth, heads) in enumerate(zip(ENC_CHANNELS, ENC_DEPTHS, ENC_HEADS)):
            entry = Pooling(ENC_CHANNELS[s - 1], c) if s > 0 else None
            drops = enc_drop[sum(ENC_DEPTHS[:s]): sum(ENC_DEPTHS[:s + 1])]
            self.enc.append(Stage(entry, c, depth, heads, drops, site))
            site += depth
        dec_drop = torch.linspace(0, DROP_PATH, sum(DEC_DEPTHS), device="cpu").tolist()
        dec_in = list(DEC_CHANNELS) + [ENC_CHANNELS[-1]]
        stages = {}
        for s in reversed(range(len(DEC_CHANNELS))):
            drops = dec_drop[sum(DEC_DEPTHS[:s]): sum(DEC_DEPTHS[:s + 1])][::-1]
            entry = Unpooling(dec_in[s + 1], ENC_CHANNELS[s], DEC_CHANNELS[s])
            stages[s] = Stage(entry, DEC_CHANNELS[s], DEC_DEPTHS[s], DEC_HEADS[s], drops, site)
            site += DEC_DEPTHS[s]
        self.dec = nn.ModuleList([stages[s] for s in range(len(DEC_CHANNELS))])
        self.head = nn.Linear(DEC_CHANNELS[0], num_classes)

    def forward(self, feats: torch.Tensor, plan: UNetPlan, draws: Optional[StepDraws] = None):
        """feats [B, cap0, in_channels]; ``draws`` in train mode (None: no
        shuffle, no drop path)."""
        if not self.training:
            draws = None
        lv, dn = plan.levels, plan.downs
        with profiling.span("ptv3.serialize"):
            levels = _serialize(plan, draws)
        nbr5 = build_subm5_nbr_batched(lv[0].coords, lv[0].valid)
        emb = self.embedding
        x = F.gelu(emb["norm"](emb["conv"](feats, nbr5, None), lv[0].valid))
        skips = []
        for s, stage in enumerate(self.enc):
            if s > 0:
                x = stage.down(x, dn[s - 1], lv[s].valid)
            x = stage.run_blocks(x, lv[s], levels[s], draws)
            skips.append(x)
        for s in reversed(range(len(self.dec))):
            stage = self.dec[s]
            x = stage.up(x, skips[s], dn[s], lv[s + 1].valid, lv[s].valid)
            x = stage.run_blocks(x, lv[s], levels[s], draws)
        logits = self.head(x) * lv[0].valid[..., None]
        return logits, x
