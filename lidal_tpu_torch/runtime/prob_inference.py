"""Multi-view probability inference over the train split (port of
``lidal_tpu/runtime/prob_inference.py``).

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
write fails the run.  Over a process group each rank runs its contiguous
share of the frame list (``cli/commands.prob_inference_command``).

Randomness: each frame's views are drawn from a ``torch.Generator`` seeded
from ``(cfg.seed, global frame index)``, all views at once, so a frame's
output depends neither on the order of the frames, nor on ``view_chunk``, nor
on whether this module or the fused round (``active/lidal_runner.py``)
computed it.

On a CUDA device a chunk's batch plan (augment, voxelize, rulebooks, point
maps: some 650 small kernels) is captured once per shape as a CUDA graph
(:class:`PlanGraph`) and replayed for every chunk; the network's forward
stays eager.  The graphs live for the process, so later calls replay what
the first captured.  On the CPU the plan runs eagerly.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.augment import AugmentDraws, sample_augment
from lidal_tpu_torch.data.pipeline import EvalBatch, forward_batch, pad_points, prepare_eval_batch
from lidal_tpu_torch.runtime.evaluate import project_logits_to_points
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir
from lidal_tpu_torch.utils import profiling


def wants_outfeat(cfg: RunConfig) -> bool:
    """reference prob_inference.py:103,116,131: r0 or metric in {ReDAL, CSET}."""
    return cfg.r_id == 0 or cfg.metric_name in ("ReDAL", "CSET")


def frame_generator(seed: int, index: int) -> torch.Generator:
    """The CPU generator of one frame's views, from the run seed and the
    frame's GLOBAL index."""
    mixed = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(mixed) & (2**63 - 1))


def eager_plan(chunk: int, level_caps: Tuple[int, ...], scale: float, full_scale: int, augment: bool,
               with_points: bool) -> Callable:
    """``plan(xyz [P, 3], sig [P], valid [P], draws) -> EvalBatch``: the
    batch of ``chunk`` views of one frame, ``draws`` the chunk's rows of
    :func:`sample_augment` (None without augmentation)."""

    def plan(xyz, sig, valid, draws):
        return prepare_eval_batch(
            None, xyz.expand((chunk,) + xyz.shape), sig.expand((chunk,) + sig.shape),
            valid.expand((chunk,) + valid.shape), level_caps=level_caps, scale=scale, full_scale=full_scale,
            augment=augment, draws=draws, with_points=with_points,
        )

    return plan


def _clone(x):
    """A copy of every tensor of a batch, in its (named) tuples."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        items = [_clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class PlanGraph:
    """:func:`eager_plan` of one shape key on a CUDA device, captured once as
    a CUDA graph and replayed for every chunk.

    Eagerly, the host takes about as long to queue a chunk's ~650 plan
    kernels as the card takes to run them; a replay is one launch.  The
    plan makes no synchronising call, as a capture requires.  A call writes
    the frame and the chunk's draws into static device buffers (the draws
    through pinned host memory), all on the current stream with no host
    wait, replays the graph on the current stream and returns a copy of its
    outputs: a later replay overwrites the graph's own tensors, never a
    batch a caller holds.  The first call runs the plan eagerly on the
    buffers, which loads its kernels and constants, returns that batch and
    then captures.  The capture's launch counts are kept aside and added at
    each replay, so ``launch.<kernel>`` counts what the card ran.  Calls
    that share a graph queue on one stream (the lock orders them)."""

    def __init__(self, device: torch.device, chunk: int, point_cap: int, level_caps: Tuple[int, ...], scale: float,
                 full_scale: int, augment: bool, with_points: bool):
        self.plan = eager_plan(chunk, level_caps, scale, full_scale, augment, with_points)
        with torch.inference_mode(False):  # written in place by callers in and out of inference mode
            self.xyz = torch.zeros((point_cap, 3), device=device)
            self.sig = torch.zeros((point_cap,), device=device)
            self.valid = torch.zeros((point_cap,), dtype=torch.bool, device=device)
            self.draws = AugmentDraws(*(torch.zeros(s, device=device) for s in ((chunk, 3, 3), (chunk, 1, 3),
                                                                                 (chunk, 1, 3)))) if augment else None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[EvalBatch] = None
        self.launches: Dict[str, int] = {}
        self.lock = threading.Lock()

    def __call__(self, xyz, sig, valid, draws: Optional[AugmentDraws]) -> EvalBatch:
        with self.lock:
            self.xyz.copy_(xyz)
            self.sig.copy_(sig)
            self.valid.copy_(valid)
            if draws is not None:
                for dst, src in zip(self.draws, draws):
                    dst.copy_(src.pin_memory(), non_blocking=True)
            if self.graph is None:
                return self._capture()
            self.graph.replay()
            profiling.count("plan_graph.replay")
            for name, n in self.launches.items():
                profiling.count(name, n)
            return _clone(self.out)

    def _capture(self) -> EvalBatch:
        batch = self.plan(self.xyz, self.sig, self.valid, self.draws)
        graph = torch.cuda.CUDAGraph()
        with profiling.diverted_counts() as launches:
            # thread_local: the other thread of a round may use the card meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.out = self.plan(self.xyz, self.sig, self.valid, self.draws)
        self.graph, self.launches = graph, launches
        profiling.count("plan_graph.capture")
        return batch


_PLAN_GRAPHS: Dict[tuple, PlanGraph] = {}  # the process's graphs: each round call replays the first's
_PLAN_GRAPHS_LOCK = threading.Lock()


def chunk_plan(device: torch.device, chunk: int, point_cap: int, level_caps: Tuple[int, ...], scale: float,
               full_scale: int, augment: bool, with_points: bool) -> Callable:
    """The chunk plan of :func:`eager_plan` on ``device``: eager on the CPU,
    the :class:`PlanGraph` of these arguments on a CUDA device."""
    if device.type != "cuda":
        return eager_plan(chunk, level_caps, scale, full_scale, augment, with_points)
    key = (device, chunk, point_cap, tuple(level_caps), scale, full_scale, augment, with_points)
    with _PLAN_GRAPHS_LOCK:
        graph = _PLAN_GRAPHS.get(key)
        if graph is None:
            graph = _PLAN_GRAPHS[key] = PlanGraph(*key)
    return graph


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
    ``augment=False`` runs every view on the unaugmented frame (parity tests).
    Each chunk's batch comes from :func:`chunk_plan`."""
    data = cfg.data
    reps = cfg.inf_reps
    if with_feat is None:
        with_feat = wants_outfeat(cfg)
    chunk = max(1, min(cfg.view_chunk, reps))
    while reps % chunk:
        chunk -= 1

    def run(generator, xyz, sig, valid):
        draws = sample_augment(generator, reps) if augment else None
        plan = chunk_plan(xyz.device, chunk, xyz.shape[0], data.level_caps, data.scale, data.full_scale, augment,
                          cfg.is_spvcnn)
        prob_sum = feat_sum = None
        for c0 in range(0, reps, chunk):
            eb = plan(xyz, sig, valid, draws.rows(c0, c0 + chunk) if augment else None)
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


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``; to a card through pinned memory, queued on the
    current stream with no host wait (a pageable copy would wait for the
    stream)."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


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
    first_index: int = 0,
):
    """Run the full multi-view dump on ``device``; returns {(seq, frame):
    (prob, pred, feat|None)} when ``save`` is False (for tests), else writes npy
    files and returns None.  ``model`` is put into eval mode.
    ``first_index``: the index of ``files[0]`` in the whole list (a rank's
    share of it), which seeds the frames' views."""
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
                    frame_generator(cfg.seed, first_index + idx),
                    *(upload(a, device) for a in (oxyz, osig, ovalid)),
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
