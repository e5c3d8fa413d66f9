"""Multi-view probability inference over the train split (port of
``lidal_tpu/runtime/prob_inference.py``, single device).

Reference parity: ``score/prob_inference.py:21-133`` — for every train frame run
``inf_reps`` (8) independently-augmented forward passes, softmax, average over
views, save per-point ``prob_map`` / ``pred`` / optional ``outfeat`` npy per
(seq, frame).  The views of a frame are the batch axis of
``prepare_eval_batch`` and of the eval-mode network; they run in chunks of
``cfg.view_chunk`` whose softmax sums are added and divided by the view count
at the end.  Only the final [P, C] arrays cross to the host for saving.

Frames run one after another in a Python loop (the JAX package's
``frames_per_dispatch`` blocks only amortised its dispatch cost), with one
frame of IO readahead, one frame of lookahead on the device (it computes frame
i + 1 while the host saves frame i) and asynchronous npy writes; a failed
write fails the run.

Randomness: each frame's views are drawn from a ``torch.Generator`` seeded
from ``(cfg.seed, global frame index)``, all views at once, so a frame's
output depends neither on the order of the frames, nor on ``view_chunk``, nor
on whether this module or the fused round (``active/lidal_runner.py``)
computed it.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.augment import sample_augment
from lidal_tpu_torch.data.pipeline import forward_batch, pad_points, prepare_eval_batch
from lidal_tpu_torch.runtime.evaluate import project_logits_to_points
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir


def wants_outfeat(cfg: RunConfig) -> bool:
    """reference prob_inference.py:103,116,131: r0 or metric in {ReDAL, CSET}."""
    return cfg.r_id == 0 or cfg.metric_name in ("ReDAL", "CSET")


def frame_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator of one frame's views, from the run seed and the
    frame's GLOBAL index."""
    mixed = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(mixed) & (2**63 - 1))


def make_multiview_fn(cfg: RunConfig, model: torch.nn.Module, with_feat: Optional[bool] = None,
                      augment: bool = True):
    """Builds ``fn(generator, xyz [P, 3], sig [P], valid [P]) -> (prob_mean
    [P, C] f32, pred [P] i32, outfeat_mean [P, F] f32 | None)`` on the tensors'
    device, for an eval-mode ``model``.

    ``with_feat`` defaults to :func:`wants_outfeat`; when False the per-view
    feature projection/mean is dropped (LiDAL rounds >= 1 never read outfeat —
    reference prob_inference.py:103,116,131).

    Views run in chunks of ``cfg.view_chunk`` (the largest divisor of
    ``inf_reps`` not above it): each chunk's softmax probabilities/features
    are summed and the mean is taken over all views at the end — the
    reference's single mean over 8 views (prob_inference.py:107-118).
    ``augment=False`` runs every view on the unaugmented frame (parity tests)."""
    data = cfg.data
    reps = cfg.inf_reps
    if with_feat is None:
        with_feat = wants_outfeat(cfg)
    chunk = max(1, min(cfg.view_chunk, reps))
    while reps % chunk:
        chunk -= 1

    def run(generator, xyz, sig, valid):
        draws = sample_augment(generator, reps) if augment else None
        xyz_r = xyz.expand((chunk,) + xyz.shape)
        sig_r = sig.expand((chunk,) + sig.shape)
        val_r = valid.expand((chunk,) + valid.shape)
        prob_sum = feat_sum = None
        for c0 in range(0, reps, chunk):
            eb = prepare_eval_batch(
                None, xyz_r, sig_r, val_r,
                level_caps=data.level_caps, scale=data.scale, full_scale=data.full_scale,
                augment=augment, draws=draws.rows(c0, c0 + chunk) if augment else None,
                with_points=cfg.is_spvcnn,
            )
            logits, feat = forward_batch(model, eb)
            prob = torch.softmax(project_logits_to_points(logits, eb.inverse).float(), dim=-1).sum(dim=0)
            prob_sum = prob if prob_sum is None else prob_sum + prob
            if with_feat:
                feat_p = project_logits_to_points(feat, eb.inverse).float().sum(dim=0)
                feat_sum = feat_p if feat_sum is None else feat_sum + feat_p
        prob_mean = prob_sum / reps
        pred = prob_mean.argmax(dim=-1).to(torch.int32)
        return prob_mean, pred, (feat_sum / reps if with_feat else None)

    return run


def to_host(t: Optional[torch.Tensor]):
    """Start a copy of ``t`` to (pinned) host memory; returns (host tensor,
    event to wait for, or None when ``t`` is already on the host)."""
    if t is None or t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def check_writes(futures: List[Future], wait: bool) -> None:
    """Raise what a finished write raised (``wait``: wait for all of them first)."""
    for f in list(futures):
        if wait or f.done():
            f.result()
            futures.remove(f)


def run_prob_inference(
    cfg: RunConfig,
    model: torch.nn.Module,
    files: Sequence[str],
    read_fn: Callable,  # path -> (xyz, sig, labels-or-None)
    frame_id_fn: Callable,  # path -> (seq, frame)
    point_cap: Optional[int] = None,
    save: bool = True,
    verbose: bool = False,
    device: Union[torch.device, str] = "cuda",
    augment: bool = True,
):
    """Run the full multi-view dump on ``device``; returns {(seq, frame):
    (prob, pred, feat|None)} when ``save`` is False (for tests), else writes npy
    files and returns None.  ``model`` is put into eval mode."""
    device = torch.device(device)
    paths = Paths(cfg)
    cap = point_cap or cfg.data.point_cap
    with_feat = wants_outfeat(cfg)
    fn = make_multiview_fn(cfg, model.eval(), augment=augment)
    results = {} if not save else None
    if not files:
        return results

    def load(idx: int):
        xyz, sig, _ = read_fn(files[idx])
        oxyz, osig, ovalid, _ = pad_points(xyz, sig, None, cap)
        return len(xyz), oxyz, osig, ovalid

    def write(seq, frame, prob, pred, feat):
        np.save(os.path.join(ensure_dir(paths.prob_dir(seq)), f"{frame}.npy"), prob)
        np.save(os.path.join(ensure_dir(paths.pred_dir(seq)), f"{frame}.npy"), pred)
        if feat is not None:
            np.save(os.path.join(ensure_dir(paths.outfeat_dir(seq)), f"{frame}.npy"), feat)

    writes: List[Future] = []

    def emit(idx, n, outs, event):
        if event is not None:
            event.synchronize()  # this frame's copies; the next frame goes on computing
        prob, pred, feat = (None if t is None else t.numpy()[:n] for t in outs)
        seq, frame = frame_id_fn(files[idx])
        if save:
            writes.append(writer.submit(write, seq, frame, prob, pred, feat))
            check_writes(writes, wait=False)
        else:
            results[(seq, frame)] = (prob, pred, feat)
        if verbose:
            print(f"Processing {seq}/{frame}")

    reader = ThreadPoolExecutor(max_workers=1)
    writer = ThreadPoolExecutor(max_workers=1)
    try:
        with torch.inference_mode():
            next_load = reader.submit(load, 0)
            pending = None
            for idx in range(len(files)):
                n, oxyz, osig, ovalid = next_load.result()
                if idx + 1 < len(files):
                    next_load = reader.submit(load, idx + 1)
                out = fn(
                    frame_generator(cfg.seed, idx),
                    *(torch.from_numpy(a).to(device) for a in (oxyz, osig, ovalid)),
                )
                hosts, event = [], None
                for t in out:
                    host, ev = to_host(t)
                    hosts.append(host)
                    event = ev or event
                if pending is not None:
                    emit(*pending)  # drains frame i - 1 while frame i computes
                pending = (idx, min(n, cap), hosts, event)
            emit(*pending)
        writer.shutdown(wait=True)
        check_writes(writes, wait=True)
    finally:
        reader.shutdown(wait=True, cancel_futures=True)
        writer.shutdown(wait=True)
    return results
