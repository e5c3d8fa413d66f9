"""LiDAL scoring round orchestrator (port of ``lidal_tpu/active/lidal_runner.py``;
reference ``score/sv_level/LiDAL.py`` main).

Flow per round r >= 1 (all paths per the reference taxonomy):

1. accumulate previous-round sv flags per sequence (round 1 reads the 0r
   bootstrap) with frame offsets + current-round save paths (``:137-167``);
2. for every frame: score inter-frame divergence/entropy against its 24
   pose-registered neighbors — on the device, with neighbor hash grids and
   grid-sorted probability maps resident in a RING of slots (consecutive
   frames share 22/24 neighbors: two in-place slot writes per frame instead
   of any re-stack or re-upload);
3. aggregate per supervoxel; lazily persist global sv_pnums / sv_centers with the
   per-sequence +1000*seq_idx center offset (``:175-222``);
4. greedy AL + SL selection; write per-frame flag npys for round r (``:230-330``).

Threads and the device.  A one-worker pool warms the ring for frame i + 1
(host loads, uploads, and in the fused round the multi-view inference) while
the caller's thread scores frame i and aggregates frame i - 1.  Both threads
queue their device work on the one current stream, and the score of frame i
is queued before the prefetch of frame i + 1 is submitted, so a slot write
never overtakes a score that still reads the slot.  ``torch.inference_mode``
and the current device are per thread: the worker enters its own.  The
kernels' launch counts stay exact across the two threads: each wrapper adds
to its count in ``utils.profiling`` under the recorder's lock.

Spans (``utils.profiling``): on the caller's thread ``round.wait_prefetch``, ``round.score``, ``round.copy_wait``,
``round.aggregate`` per scored frame and ``round.select`` once; on the
prefetch thread ``round.read_frame``, ``round.infer`` (fused round) and
``round.ring_insert`` per frame entering the ring.

Over a process group (``group``) each rank scores its contiguous share of
every sequence's frames (``parallel/mesh.process_shard``; its ring also
loads the neighbours beyond the share), the ranks' per-supervoxel scores are
summed (each supervoxel belongs to one frame, so a sum of one score and
zeros), every rank selects, and rank 0 alone writes the flags and the
statistics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from lidal_tpu_torch.active import lidal
from lidal_tpu_torch.active.nn_match import HashGrid, build_grid
from lidal_tpu_torch.config import RunConfig
from lidal_tpu_torch.data.pipeline import pad_points
from lidal_tpu_torch.data.selection import load_sv_info
from lidal_tpu_torch.ops.cuda_nnband import BIG_COORD, TN
from lidal_tpu_torch.ops.hashing import SENTINEL_KEY
from lidal_tpu_torch.parallel import mesh
from lidal_tpu_torch.prep.grid import load_grid_points
from lidal_tpu_torch.runtime.paths import Paths, ensure_dir
from lidal_tpu_torch.runtime.prob_inference import check_writes, frame_generator, make_multiview_fn, to_host, upload
from lidal_tpu_torch.utils import profiling


def _prev_cfg(cfg: RunConfig) -> RunConfig:
    """The previous round's config (LiDAL.py:188-191): r==1 reads fr/0r."""
    if cfg.r_id == 1:
        return dataclasses.replace(cfg, r_id=0, label_unit="fr")
    return dataclasses.replace(cfg, r_id=cfg.r_id - 1, label_unit="sv")


def _prev_prob_dir(cfg: RunConfig, seq: str) -> str:
    """prob maps of the previous round (LiDAL.py:188-191): r==1 reads fr/0r."""
    return Paths(_prev_cfg(cfg)).prob_dir(seq)


@contextlib.contextmanager
def _device_scope(device: torch.device):
    """What every thread that queues device work enters: no autograd graphs,
    and ``device`` as the thread's current CUDA device."""
    with torch.inference_mode():
        if device.type == "cuda":
            with torch.cuda.device(device):
                yield
        else:
            yield


class NeighborRing:
    """Ring of (hash grid, grid-sorted prob) slots on one device, stacked on a
    leading slot axis so scoring is ONE kernel launch over all neighbors.

    Consecutive query frames share 22/24 neighbors; only evicted slots are
    rewritten, in place.  Duplicate neighbor ids (the reference's
    end-of-sequence reflection) ride a per-frame weight vector.  Slots that
    hold no frame carry sentinel keys and BIG coordinates, so their bands are
    empty.

    A frame's scores are summed over the slots in slot order, so they depend
    on which slot holds which neighbour, which the ring's history decides.  A
    rank whose share starts mid-sequence replays the slot assignments of the
    frames before its share (:meth:`ensure` without a loader) and so sums in
    the same order as one ring over the whole sequence."""

    def __init__(self, nslots: int, cap: int, device: Union[torch.device, str] = "cuda"):
        self.nslots = nslots
        self.cap_in = cap
        self.cap = -(-cap // TN) * TN  # the grids' rounded capacity
        self.device = torch.device(device)
        self.key2slot: Dict = {}
        self.free = list(range(nslots))
        self.state = None  # allocated on first ensure() (class count from data)
        self.meta: Dict = {}  # key -> (true point count, host xyz) for aggregation; the keys loaded

    def _alloc(self, num_classes: int) -> None:
        s, cap, dev = self.nslots, self.cap, self.device
        grids = HashGrid(
            key_hi=torch.full((s, cap), SENTINEL_KEY, dtype=torch.int32, device=dev),
            key_lo=torch.full((s, cap), SENTINEL_KEY, dtype=torch.int32, device=dev),
            planar=torch.full((s, 3, cap), BIG_COORD, dtype=torch.float32, device=dev),
            src_idx=torch.zeros((s, cap), dtype=torch.int32, device=dev),
            valid=torch.zeros((s, cap), dtype=torch.bool, device=dev),
        )
        probs = torch.zeros((s, cap, num_classes), dtype=torch.float32, device=dev)
        self.state = (grids, probs)

    def _insert(self, slot: int, xyz_pad: torch.Tensor, n: int, prob_pad: torch.Tensor) -> None:
        """Build the frame's hash grid and write it and its grid-sorted prob
        into ``slot``, in place.  ``xyz_pad`` [cap_in, 3] and ``prob_pad``
        [cap_in, C] are zero past row ``n``."""
        valid = torch.arange(self.cap_in, device=self.device) < n
        grid = build_grid(xyz_pad, valid, lidal.DIS_THRESH)
        grids, probs = self.state
        for dst, src in zip(grids, grid):
            dst[slot] = src
        if self.cap != self.cap_in:
            prob_pad = torch.cat([prob_pad, prob_pad.new_zeros((self.cap - self.cap_in, prob_pad.shape[1]))])
        probs[slot] = prob_pad[grid.src_idx.long()]

    def ensure(self, keys: Sequence, loader: Optional[Callable]) -> None:
        """Make every key resident; ``loader(key) -> (xyz [n,3], prob [n,c])``
        with ``prob`` a numpy array or, in the fused round, a device tensor
        [cap_in, c].  Without a loader only assign the keys their slots (a
        replay: they load when a later call still wants them)."""
        wanted = set(keys)
        missing = [k for k in wanted if k not in self.key2slot]
        if missing:
            for k in [k for k in list(self.key2slot) if k not in wanted]:
                self.free.append(self.key2slot.pop(k))
                self.meta.pop(k, None)
            for k in missing:
                self.key2slot[k] = self.free.pop()
        if loader is None:
            return
        for k in [k for k in wanted if k not in self.meta]:
            xyz, prob = loader(k)
            if self.state is None:
                self._alloc(int(prob.shape[1]))
            n = min(len(xyz), self.cap_in)
            self.meta[k] = (n, xyz)
            slot = self.key2slot[k]
            if isinstance(prob, torch.Tensor):
                # fused-round path: prob is the inference output [cap_in, C],
                # already on the device; upload only the registered coords.
                # Pad rows are zeroed so the slot equals the staged path's.
                assert prob.shape[0] == self.cap_in, (prob.shape, self.cap_in)
                buf = np.zeros((self.cap_in, 3), np.float32)
                buf[:n] = xyz[:n]
                rows = torch.arange(self.cap_in, device=self.device) < n
                prob = torch.where(rows[:, None], prob.float(), 0.0)
                xyz_pad = torch.from_numpy(buf).to(self.device)
            else:
                # one packed upload (xyz | prob)
                buf = np.zeros((self.cap_in, 3 + prob.shape[1]), np.float32)
                buf[:n, :3] = xyz[:n]
                buf[:n, 3:] = prob[:n]
                dbuf = torch.from_numpy(buf).to(self.device)
                xyz_pad, prob = dbuf[:, :3].contiguous(), dbuf[:, 3:]
            with profiling.span("round.ring_insert"):
                self._insert(slot, xyz_pad, n, prob)

    def weights(self, keys: Sequence) -> np.ndarray:
        """Per-slot multiplicity of ``keys`` (0 for unused slots)."""
        w = np.zeros((self.nslots,), np.float32)
        for k in keys:
            w[self.key2slot[k]] += 1.0
        return w


def _load_prev_flags(cfg: RunConfig, paths: Paths, split: Sequence[str]):
    """Stage 1 of a scoring round (LiDAL.py:137-167): concatenate the previous
    round's per-frame sv flags and compute this round's save paths."""
    sv_flags_list: List[np.ndarray] = []
    save_paths: List[str] = []
    frame_names: Dict[str, List[str]] = {}
    for seq in split:
        if cfg.r_id == 1:
            fdir = paths.sv_flag_dir(seq, r_id=0)
        else:
            fdir = Paths(dataclasses.replace(cfg, r_id=cfg.r_id - 1)).sv_flag_dir(seq)
        names = sorted(f[:-4] for f in os.listdir(fdir) if f.endswith(".npy"))
        frame_names[seq] = names
        out_dir = ensure_dir(paths.sv_flag_dir(seq))
        for name in names:
            sv_flags_list.append(np.load(os.path.join(fdir, f"{name}.npy")).astype(np.int64))
            save_paths.append(os.path.join(out_dir, f"{name}.npy"))
    frame_sv_offsets = np.cumsum([0] + [len(f) for f in sv_flags_list])
    sv_flags = np.concatenate(sv_flags_list) if sv_flags_list else np.zeros(0, np.int64)
    return sv_flags, save_paths, frame_names, frame_sv_offsets


class _SvAggregator:
    """Per-supervoxel score accumulation across frames (LiDAL.py:84-103,218),
    with lazy global sv_pnums / sv_centers persistence on the first-ever round."""

    def __init__(self, cfg: RunConfig, n_sv_total: int):
        self.stats_dir = os.path.join(
            cfg.processing_root, cfg.dataset_name, "super_voxel", "KMeans"
        )
        self.pnums_path = os.path.join(self.stats_dir, "sv_pnums.npy")
        self.centers_path = os.path.join(self.stats_dir, "sv_centers.npy")
        self.pre = os.path.exists(self.pnums_path)
        if self.pre:
            self.sv_pnums = np.load(self.pnums_path)
            self.sv_centers = np.load(self.centers_path)
        else:
            self.sv_pnums = np.zeros(n_sv_total, np.int64)
            self.sv_centers = np.zeros((n_sv_total, 3), np.float32)
        self.sv_interds = np.zeros(n_sv_total, np.float32)
        self.sv_interes = np.zeros(n_sv_total, np.float32)
        self.lock = threading.Lock()

    def make_aggregate(self, seq: str, seq_idx: int, svi_dir: str, names, verbose: bool):
        """Per-sequence aggregate(fi, p, q_xyz, scores): fold one frame's
        [2, cap] scores (ONE transfer from the device) into the sv arrays."""

        def aggregate(fi: int, p: int, q_xyz, scores_t):
            name = names[fi]
            scores = scores_t.cpu().numpy()
            interd = scores[0, :p]
            intere = scores[1, :p]
            point2sv, sv_gid = load_sv_info(os.path.join(svi_dir, f"{name}.npz"))
            n_sv = len(sv_gid)
            if self.pre:
                d, e, _ = lidal.sv_aggregate(interd, intere, point2sv, n_sv)
                with self.lock:
                    self.sv_interds[sv_gid] = d
                    self.sv_interes[sv_gid] = e
            else:
                d, e, cnt, ctr = lidal.sv_aggregate(interd, intere, point2sv, n_sv, q_xyz)
                with self.lock:
                    self.sv_pnums[sv_gid] = cnt
                    # +1000 * seq idx so centers of different sequences never
                    # collide (LiDAL.py:218)
                    self.sv_centers[sv_gid] = ctr + seq_idx * 1000.0
                    self.sv_interds[sv_gid] = d
                    self.sv_interes[sv_gid] = e
            if verbose:
                print(f"Processing frame {seq}_{fi}")

        return aggregate

    def save_stats(self) -> None:
        if not self.pre:
            ensure_dir(self.stats_dir)
            np.save(self.pnums_path, self.sv_pnums)
            np.save(self.centers_path, self.sv_centers)

    def all_reduce(self, group: Optional[dist.ProcessGroup], device: torch.device) -> None:
        """Sum what the ranks aggregated (each rank wrote its frames'
        supervoxels and left the others 0; loaded statistics stay as loaded)."""
        if group is None:
            return
        arrays = [self.sv_interds, self.sv_interes] + ([] if self.pre else [self.sv_pnums, self.sv_centers])
        for a in arrays:
            a[...] = mesh.all_reduce_(torch.from_numpy(a).to(device), group).cpu().numpy()


def _score_frames(chunk: range, n_frames: int, device: torch.device, cap: int, loader: Callable,
                  aggregate: Callable, after_frame: Callable = lambda: None) -> None:
    """Score the frames of ``chunk`` (of a sequence of ``n_frames``) through
    a ring on ``device``: ``loader(frame index) -> (xyz, prob)`` fills it (on
    the prefetch thread), ``aggregate(fi, p, q_xyz, scores)`` folds each
    frame's result."""
    if not chunk:
        return
    # +2 slots: the query frame itself stays resident (it becomes a neighbor
    # of the next 12 frames with no re-upload), plus slack for
    # end-of-sequence reflection windows.
    ring = NeighborRing(lidal.NEI_NUM + 2, cap, device=device)
    for fi in range(chunk.start):  # the slots a ring over the whole sequence holds here
        ring.ensure([fi] + lidal.neighbor_ids(fi, n_frames), None)

    def prefetch(fi):
        """Warm the ring for frame fi on the IO thread."""
        with _device_scope(device):
            ring.ensure([fi] + lidal.neighbor_ids(fi, n_frames), loader)

    def drain(fi, p, q_xyz, scores, copied):
        with profiling.span("round.copy_wait"):
            if copied is not None:
                copied.synchronize()  # this frame's [2, cap] copy only
        with profiling.span("round.aggregate"):
            aggregate(fi, p, q_xyz, scores)

    io = ThreadPoolExecutor(max_workers=1)
    try:
        with _device_scope(device):
            nxt = io.submit(prefetch, chunk[0])
            pending = None  # (fi, p, q_xyz, stacked [2, cap] scores on the host, copy event)
            for fi in chunk:
                with profiling.span("round.wait_prefetch"):
                    nxt.result()
                with profiling.span("round.score"):
                    w = ring.weights(lidal.neighbor_ids(fi, n_frames))
                    p, q_xyz = ring.meta[fi]
                    scores, copied = to_host(lidal.score_slot(ring.state, ring.key2slot[fi], w))
                # submitted after the score is queued: the slot writes of
                # frame fi + 1 follow it on the stream
                if fi + 1 in chunk:
                    nxt = io.submit(prefetch, fi + 1)
                if pending is not None:
                    drain(*pending)  # frame i-1, while frame i computes
                pending = (fi, p, q_xyz, scores, copied)
                after_frame()
            drain(*pending)
    finally:
        io.shutdown(wait=True, cancel_futures=True)


def _select_and_save(sv_flags, agg: _SvAggregator, tpn: int, save_paths, frame_sv_offsets,
                     group: Optional[dist.ProcessGroup], device: torch.device):
    """Stage 4: greedy selection over the aggregated scores, one flag npy per
    frame (under a group: the group's scores, written by rank 0)."""
    with profiling.span("round.select"):
        lead = mesh.rank(group) == 0
        agg.all_reduce(group, device)
        if lead:
            agg.save_stats()
        result = lidal.select(sv_flags, agg.sv_interds, agg.sv_interes, agg.sv_pnums, agg.sv_centers, tpn)
        if lead:
            for i, sp in enumerate(save_paths):
                np.save(sp, result.sv_flags[frame_sv_offsets[i] : frame_sv_offsets[i + 1]])
        mesh.sync_hosts("select", group)
    return result


def run_lidal_round(
    cfg: RunConfig,
    train_split: Sequence[str] | None = None,
    train_point_num: int | None = None,
    verbose: bool = False,
    device: Union[torch.device, str] = "cuda",
    group: Optional[dist.ProcessGroup] = None,
) -> lidal.SelectionResult:
    """Execute one full LiDAL scoring + selection round on ``device`` (over
    the ranks of ``group``) from the previous round's prob npys; writes flag
    files and returns the selection."""
    assert cfg.r_id >= 1
    assert cfg.metric_name.startswith("LiDAL")
    device = torch.device(device)
    data = cfg.data
    split = list(train_split or data.train_split)
    tpn = train_point_num or data.train_point_num
    paths = Paths(cfg)

    sv_flags, save_paths, frame_names, frame_sv_offsets = _load_prev_flags(cfg, paths, split)
    agg = _SvAggregator(cfg, len(sv_flags))

    for seq_idx, seq in enumerate(split):
        prob_dir = _prev_prob_dir(cfg, seq)
        grid_dir = paths.grid_dir(seq)
        names = frame_names[seq]

        def load_frame(ni: int):
            nname = names[ni]
            with profiling.span("round.read_frame"):
                xyz = load_grid_points(os.path.join(grid_dir, f"{nname}.npz")).astype(np.float32)
                prob = np.load(os.path.join(prob_dir, f"{nname}.npy")).astype(np.float32)
            return xyz, prob

        aggregate = agg.make_aggregate(seq, seq_idx, paths.supervoxel_dir(seq, "KMeans"), names, verbose)
        _score_frames(mesh.process_shard(len(names), group), len(names), device, data.point_cap, load_frame,
                      aggregate)

    return _select_and_save(sv_flags, agg, tpn, save_paths, frame_sv_offsets, group, device)


def run_fused_lidal_round(
    cfg: RunConfig,
    model: torch.nn.Module,
    read_fn: Callable,  # (seq, name) -> (xyz [n,3] f32, sig [n] f32) raw frame reader
    train_split: Sequence[str] | None = None,
    train_point_num: int | None = None,
    save_prob: bool = True,
    verbose: bool = False,
    device: Union[torch.device, str] = "cuda",
    frame_index: Optional[Dict] = None,
    group: Optional[dist.ProcessGroup] = None,
) -> lidal.SelectionResult:
    """FUSED single-pass active round: multi-view probability inference and
    LiDAL scoring stream through the device together.

    The staged pipeline (reference ``score/prob_inference.py`` then
    ``score/sv_level/LiDAL.py``) couples the two stages through the
    filesystem: every frame's ~10 MB float32 prob map is pulled to the host,
    written to npy, re-read, and re-uploaded for scoring.  Here the inference
    output FEEDS THE SCORING RING DIRECTLY: per steady-state frame the
    host<->device traffic is one raw-frame upload, one registered-coords
    upload, and one [2, cap] score pull.  ``save_prob`` still writes the
    prob/pred npy artifacts (on a writer thread, off the critical path) so the
    on-disk contract is unchanged — pseudo-label training reads pred
    (reference ``sk_dataset.py:122-141``), and a staged run can reuse the prob
    dumps.  A failed write fails the round: each write is checked as it
    completes, and all of them at the end.

    Ranks split the frames as :func:`run_lidal_round` does; a rank also
    infers the neighbours beyond its share, and saves only its own frames'
    maps.

    Parity: probabilities come from the same function as
    :func:`runtime.prob_inference.run_prob_inference`, with each frame's
    generator seeded from the same global frame index, so prob maps, scores
    and selections are identical to the staged pipeline's.

    ``model`` must be the PREVIOUS round's model (the one whose prob maps
    round ``cfg.r_id`` scores): reference LiDAL.py:188-191.

    Args:
      frame_index: {(seq, name): global index} for the frames' generators.
        Pass the dataset enumeration order used by ``run_prob_inference`` (the
        command does); defaults to split-order/sorted-name enumeration, which
        matches it whenever every train frame has a flag file.
    """
    assert cfg.r_id >= 1
    assert cfg.metric_name.startswith("LiDAL")
    device = torch.device(device)
    data = cfg.data
    split = list(train_split or data.train_split)
    tpn = train_point_num or data.train_point_num
    paths = Paths(cfg)
    cap = data.point_cap

    inf_cfg = _prev_cfg(cfg)
    inf_paths = Paths(inf_cfg)
    # with_feat=False: LiDAL scoring never reads outfeat (prob/pred are
    # unaffected by dropping the feature branch)
    fn = make_multiview_fn(inf_cfg, model.eval(), with_feat=False)

    sv_flags, save_paths, frame_names, frame_sv_offsets = _load_prev_flags(cfg, paths, split)
    agg = _SvAggregator(cfg, len(sv_flags))

    if frame_index is None:
        frame_index = {}
        for seq in split:
            for name in frame_names[seq]:
                frame_index[(seq, name)] = len(frame_index)

    writer = ThreadPoolExecutor(max_workers=1)
    writes: List[Future] = []
    try:
        for seq_idx, seq in enumerate(split):
            grid_dir = paths.grid_dir(seq)
            names = frame_names[seq]
            share = mesh.process_shard(len(names), group)
            prob_dir = ensure_dir(inf_paths.prob_dir(seq)) if save_prob else None
            pred_dir = ensure_dir(inf_paths.pred_dir(seq)) if save_prob else None

            def save_frame(name: str, n_raw: int, prob_t, pred_t):
                np.save(os.path.join(prob_dir, f"{name}.npy"), prob_t.cpu().numpy()[:n_raw])
                np.save(os.path.join(pred_dir, f"{name}.npy"), pred_t.cpu().numpy()[:n_raw])

            def infer_frame(ni: int):
                """Ring loader (runs on the prefetch thread, inside its device
                scope): multi-view inference on the device; only the
                registered coords upload."""
                name = names[ni]
                with profiling.span("round.read_frame"):
                    xyz_raw, sig = read_fn(seq, name)
                    oxyz, osig, ovalid, _ = pad_points(xyz_raw, sig, None, cap)
                with profiling.span("round.infer"):
                    prob_t, pred_t, _ = fn(
                        frame_generator(inf_cfg.seed, frame_index[(seq, name)]),
                        *(upload(a, device) for a in (oxyz, osig, ovalid)),
                    )
                if save_prob and ni in share:  # a neighbour beyond the share is saved by its own rank
                    writes.append(writer.submit(save_frame, name, len(xyz_raw), prob_t, pred_t))
                gxyz = load_grid_points(os.path.join(grid_dir, f"{name}.npz")).astype(np.float32)
                return gxyz, prob_t

            aggregate = agg.make_aggregate(seq, seq_idx, paths.supervoxel_dir(seq, "KMeans"), names, verbose)
            _score_frames(share, len(names), device, cap, infer_frame, aggregate,
                          after_frame=lambda: check_writes(writes, wait=False))
        writer.shutdown(wait=True)
        check_writes(writes, wait=True)
    finally:
        writer.shutdown(wait=True)

    return _select_and_save(sv_flags, agg, tpn, save_paths, frame_sv_offsets, group, device)
