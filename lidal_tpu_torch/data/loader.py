"""Host-side frame loading with background prefetch (port of
``lidal_tpu/data/loader.py``, numpy only).

Replaces torch DataLoader workers (reference ``sk_dataloader.py:48-56``,
num_workers=4, pin_memory): a thread pool reads/pads frames while the device
computes, and ``data/pipeline.prepare_*_batch`` does augmentation/voxelization
on the device — the host does no more than file IO and label remap.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Callable, Iterator, List, Sequence

import numpy as np

from lidal_tpu_torch.data.pipeline import IGNORE_LABEL, pad_points


class FrameBatchLoader:
    """Yields dict batches of stacked padded numpy arrays.

    Args:
      files: frame identifiers (paths or manifest entries).
      read_fn: file -> (xyz [N,3] f32, sig [N] f32, labels [N] int32 or None).
      point_cap: fixed per-frame point capacity.
      batch_size: frames per batch.
      shuffle: reshuffle each epoch with the epoch-seeded RNG
        (DistributedSampler.set_epoch parity, reference train.py:118-119).
      rank/world: contiguous static shard of the file list (score loader parity,
        reference sk_dataloader.py:196-198) when ``contiguous_shard`` else strided.
      drop_last: drop the ragged final batch.
    """

    def __init__(
        self,
        files: Sequence,
        read_fn: Callable,
        point_cap: int,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        contiguous_shard: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
    ):
        self.files = list(files)
        self.read_fn = read_fn
        self.point_cap = point_cap
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world = world
        self.contiguous_shard = contiguous_shard
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_files(self) -> List:
        files = self.files
        if self.world > 1:
            if self.contiguous_shard:
                n = -(-len(files) // self.world)
                files = files[self.rank * n : (self.rank + 1) * n]
            else:
                files = files[self.rank :: self.world]
        files = list(files)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(files)
        return files

    def __len__(self) -> int:
        n = len(self._epoch_files())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _load_one(self, f):
        xyz, sig, labels = self.read_fn(f)
        oxyz, osig, ovalid, olab = pad_points(xyz, sig, labels, self.point_cap)
        trunc = max(0, len(xyz) - self.point_cap)
        return f, oxyz, osig, ovalid, olab, trunc

    def __iter__(self) -> Iterator[dict]:
        files = self._epoch_files()
        batches = [
            files[i : i + self.batch_size] for i in range(0, len(files), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # A producer failure (unreadable frame, bad read_fn) must surface
            # in the consumer — a died thread would otherwise leave __iter__
            # blocked on the queue forever.
            try:
                _produce()
            except BaseException as e:  # noqa: BLE001 — re-raised by consumer
                out_q.put(e)

        def _produce():
            with cf.ThreadPoolExecutor(max(1, self.num_workers)) as pool:
                for bfiles in batches:
                    if stop.is_set():
                        return
                    items = list(pool.map(self._load_one, bfiles))
                    b = len(items)
                    # pad the ragged final batch with invalid frames (static shapes)
                    bsz = self.batch_size
                    xyz = np.zeros((bsz, self.point_cap, 3), np.float32)
                    sig = np.zeros((bsz, self.point_cap), np.float32)
                    valid = np.zeros((bsz, self.point_cap), bool)
                    labels = np.full((bsz, self.point_cap), IGNORE_LABEL, np.int32)
                    names = []
                    trunc_points = 0
                    for i, (f, oxyz, osig, ovalid, olab, trunc) in enumerate(items):
                        xyz[i], sig[i], valid[i], labels[i] = oxyz, osig, ovalid, olab
                        names.append(f)
                        trunc_points += trunc
                    out_q.put(
                        {
                            "files": names,
                            "n_frames": b,
                            "xyz": xyz,
                            "sig": sig,
                            "valid": valid,
                            "labels": labels,
                            "trunc_points": trunc_points,
                        }
                    )
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
