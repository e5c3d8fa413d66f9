"""Plain reference of the first train steps of a run: the same frames, the
same draws, the same initial weights, and a plain f32 forward, loss,
backward and Adam (lr 1e-3, betas (0.9, 0.999), eps 1e-8; reference
``train.py:56``) on the device, with TF32 off unless ``tf32`` asks for the
control.

``fault`` plants one of the faults the check must catch, in the reference
put in the program's place: ``half_batch`` (the loss of each step over the
first half of the batch's frames alone) or ``frozen`` (no update).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lidal_bench.reference import data as rdata
from lidal_bench.reference.model import Maps, build


@contextlib.contextmanager
def tf32(on: bool):
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def prepare(paths: Sequence[str], draws: rdata.Draws, cfg: Dict, device):
    """(voxel features [n, 4], voxel labels [n], frames) of one batch."""
    xyz, sig, valid, labels = (torch.from_numpy(a).to(device)
                               for a in rdata.padded_batch(paths, cfg["point_cap"]))
    xa, coords, ok = rdata.voxel_coords(xyz, valid, draws, cfg["scale"], cfg["full_scale"])
    feats, labs, frames = [], [], []
    for b in range(len(paths)):
        pts = ok[b].nonzero()[:, 0]
        fr = rdata.build_frame(coords[b, pts], cfg["level_caps"])
        src = pts[fr.first]
        feats.append(torch.cat([xa[b, src], sig[b, src, None]], 1).float())
        labs.append(labels[b, src])
        frames.append(fr)
    return torch.cat(feats), torch.cat(labs), frames


def loss_of(logits, labels, frame_rows: Optional[List[int]] = None, keep_frames: Optional[int] = None):
    mask = labels != rdata.IGNORE
    if keep_frames is not None:  # the half-batch fault: frames past keep_frames left out
        cut = sum(frame_rows[:keep_frames])
        mask = mask & (torch.arange(len(labels), device=labels.device) < cut)
    nll = F.cross_entropy(logits, torch.where(mask, labels, 0).long(), reduction="none")
    return (nll * mask).sum() / mask.sum().clamp_min(1)


def run_steps(batches: Sequence[Sequence[str]], weights: Dict[str, torch.Tensor], seed: int, cfg: Dict,
              device, steps: int, use_tf32: bool = False, fault: Optional[str] = None):
    """Follow the program's first ``steps`` steps.  Returns
    ``{"loss": [...], "grad1": {leaf: norm}, "delta": {leaf: norm}, "counts": [...]}``:
    the losses, each leaf's gradient norm at step 1 and each leaf's change
    after ``steps`` steps."""
    model = build(cfg["spvcnn"], cfg["num_classes"], cfg["cs"], cfg["in_channels"]).to(device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator().manual_seed(seed)
    out = {"loss": [], "grad1": {}, "delta": {}, "counts": []}
    b = cfg["batch_size"]
    for k in range(steps):
        draws = rdata.draw_augment(gen, b)
        seeds = torch.randint(0, 2**62, (b,), generator=gen).tolist() if cfg["spvcnn"] else None
        feats, labels, frames = prepare(batches[k], draws, cfg, device)
        out["counts"].append({"what": f"checked batch {k + 1}",
                              "voxels": np.sum([rdata.level_counts(fr)[0] for fr in frames], 0).tolist(),
                              "overflow": np.sum([fr.overflow for fr in frames], 0).tolist()})
        with tf32(use_tf32):  # the model only: a conv path in TF32 would leave the voxels as they are
            mp = Maps(frames)
            if cfg["spvcnn"]:
                logits = model(feats, mp, frames, seeds, cfg["level_caps"])
            else:
                logits = model(feats, mp, frames)
            rows = [len(fr.levels[0].coords) for fr in frames]
            loss = loss_of(logits, labels, rows, b // 2 if fault == "half_batch" else None)
            opt.zero_grad(set_to_none=True)
            loss.backward()
        if k == 0:
            out["grad1"] = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
        if fault != "frozen":
            opt.step()
        out["loss"].append(float(loss.detach()))
        del logits, loss, mp, feats
    out["delta"] = {n: float((p.detach() - w0[n]).norm()) for n, p in model.named_parameters()}
    return out
