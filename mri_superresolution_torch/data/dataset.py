"""Paired-PNG dataset and host-side batching.

An own copy of the JAX package's ``data/dataset.py`` (reference
utils/dataset.py:13-187): pairs matched by identical filename, subject IDs
via the ``sub-([A-Za-z0-9]+)`` regex, a seeded train/val split, and two
loaders that give the same (seed, epoch)-determined order of padded
batches with sample-weight masks (zeros mark the padding rows of a final
partial batch). For the same seed their index batches are the JAX
package's. Augmentation runs on the device in the train step
(``ops/augment.py``); this module decodes PNGs (``native.py``: the C++
codec, else cv2) and assembles numpy batches.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from mri_superresolution_torch import native


def _imread_gray(path: str) -> np.ndarray:
    return native.imread_gray(path)


class PairedSliceDataset:
    """Filename-paired HR/LR PNG dataset."""

    SUBJECT_RE = re.compile(r"sub-([A-Za-z0-9]+)")

    def __init__(self, full_res_dir: str, low_res_dir: str,
                 cache_size: int = 0):
        self.full_res_dir = Path(full_res_dir)
        self.low_res_dir = Path(low_res_dir)

        full_res_files = sorted(
            f for f in os.listdir(full_res_dir) if f.lower().endswith(".png"))

        self.valid_pairs: List[str] = []
        self.subjects: List[str] = []
        self.metadata: List[Dict] = []
        for f in full_res_files:
            if not (self.low_res_dir / f).exists():
                continue
            self.valid_pairs.append(f)
            m = self.SUBJECT_RE.search(f)
            subject = m.group(1) if m else f
            self.subjects.append(subject)
            self.metadata.append({
                "filename": f,
                "subject": subject,
                "full_res_path": str(self.full_res_dir / f),
                "low_res_path": str(self.low_res_dir / f),
            })

        self.cache_size = cache_size
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self.valid_pairs)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (lr_uint8 (h,w), hr_uint8 (H,W)) — LR first, mirroring the
        reference's (low, full) tuple order (utils/dataset.py:136)."""
        if idx in self._cache:
            return self._cache[idx]
        meta = self.metadata[idx]
        hr = _imread_gray(meta["full_res_path"])
        lr = _imread_gray(meta["low_res_path"])
        item = (lr, hr)
        if self.cache_size > 0:
            if len(self._cache) >= self.cache_size:
                self._cache.pop(next(iter(self._cache)))
            self._cache[idx] = item
        return item

    def get_subject_indices(self, subject_id: str) -> List[int]:
        return [i for i, s in enumerate(self.subjects) if s == subject_id]

    def get_unique_subjects(self) -> List[str]:
        return sorted(set(self.subjects))

    def item_hw(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """((lr_h, lr_w), (hr_h, hr_w)) of pair 0 — the extractor guarantees
        uniform sizes across a dataset. Header-only via the native reader
        when available; decodes one pair otherwise."""
        lr_hw = native.png_size(self.metadata[0]["low_res_path"])
        hr_hw = native.png_size(self.metadata[0]["full_res_path"])
        if lr_hw is None or hr_hw is None:
            lr, hr = self[0]
            lr_hw, hr_hw = lr.shape, hr.shape
        return tuple(lr_hw), tuple(hr_hw)

    def estimated_decoded_mb(self) -> float:
        """Decoded-uint8 size of the whole dataset in MiB (drives the
        trainer's auto choice between load_all and streaming)."""
        if len(self) == 0:
            return 0.0
        lr_hw, hr_hw = self.item_hw()
        per_item = lr_hw[0] * lr_hw[1] + hr_hw[0] * hr_hw[1]
        return len(self) * per_item / 2**20

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """Decode every pair into contiguous (N,h,w) / (N,H,W) uint8 arrays.
        Shapes must agree across the dataset (the extractor guarantees it).

        Uses the native C++ threaded batch decoder (native/png_loader.cpp)
        when it is built; decodes image by image otherwise.
        """
        if len(self) and native.get_lib() is not None:
            hr_paths = [m["full_res_path"] for m in self.metadata]
            lr_paths = [m["low_res_path"] for m in self.metadata]
            hr_hw = native.png_size(hr_paths[0])
            lr_hw = native.png_size(lr_paths[0])
            if hr_hw and lr_hw:
                hrs = native.decode_batch(hr_paths, hr_hw)
                lrs = native.decode_batch(lr_paths, lr_hw)
                if hrs is not None and lrs is not None:
                    return lrs, hrs

        lrs, hrs = [], []
        for i in range(len(self)):
            lr, hr = self[i]
            lrs.append(lr)
            hrs.append(hr)
        return np.stack(lrs), np.stack(hrs)


def train_val_split(n: int, validation_split: float,
                    seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic random split (role of torch random_split at
    scripts/train.py:210-213; permutation RNG is ours, seeded)."""
    val_size = int(validation_split * n)
    perm = np.random.default_rng(seed).permutation(n)
    return perm[val_size:], perm[:val_size]


def subject_split(subjects: Sequence[str], validation_split: float,
                  seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Split by SUBJECT: all slices of a subject land on the same side, so
    validation measures generalization to unseen anatomy rather than unseen
    slices of seen subjects. (Our extension — the reference's random_split
    leaks subjects across the split.) Subjects are assigned to validation in
    shuffled order until ≥ validation_split of samples are covered."""
    subjects = list(subjects)
    uniq = sorted(set(subjects))
    order = np.random.default_rng(seed).permutation(len(uniq))
    target = validation_split * len(subjects)
    val_subjects = set()
    count = 0
    for k in order:
        if count >= target:
            break
        val_subjects.add(uniq[k])
        count += sum(1 for s in subjects if s == uniq[k])
    val_idx = np.asarray([i for i, s in enumerate(subjects)
                          if s in val_subjects], dtype=np.int64)
    train_idx = np.asarray([i for i, s in enumerate(subjects)
                            if s not in val_subjects], dtype=np.int64)
    return train_idx, val_idx


class _LoaderBase:
    """Shared epoch-order/padding contract for the two batch loaders.

    Both yield dicts with ``lr`` (B,h,w,1) float32 [0,1], ``hr`` (B,H,W,1),
    and ``weight`` (B,) — zeros mark padding rows of the final partial batch
    so losses/metrics stay exact with a fixed batch shape. Identical
    (seed, epoch_idx) produce identical batch orders in both classes, so the
    trainer's resume determinism is loader-independent. With ``rows`` (a
    data-parallel rank's, ``parallel.rank_rows``) each batch holds only
    those rows of the global batch, which a streaming loader alone
    decodes."""

    def __init__(self, indices: Sequence[int], batch_size: int,
                 shuffle: bool, seed: int, rows=None):
        self.indices = np.asarray(indices, dtype=np.int64)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self.rows = None if rows is None else np.asarray(rows, np.int64)

    def __len__(self) -> int:
        return int(np.ceil(len(self.indices) / self.batch_size))

    def _epoch_index_batches(self, epoch_idx: Optional[int]
                             ) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (padded index row, n_valid) per batch. Passing ``epoch_idx``
        derives the shuffle from (seed, epoch_idx) so a resumed run
        reproduces exactly the data order a continuous run would have seen
        (SURVEY.md §5: deterministic data order for restart)."""
        if epoch_idx is not None:
            rng = np.random.default_rng((self._seed, epoch_idx))
        else:
            rng = self._rng
        order = (rng.permutation(self.indices) if self.shuffle
                 else self.indices)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            n_valid = len(idx)
            if n_valid < bs:  # pad by repeating the first row; weight 0
                idx = np.concatenate([idx, np.repeat(idx[:1], bs - n_valid)])
            yield idx, n_valid

    def _rows_of(self, idx: np.ndarray,
                 n_valid: int) -> Tuple[np.ndarray, np.ndarray]:
        """This loader's rows of a padded batch: their dataset indices and
        weights (all rows, or the ``rows`` a data-parallel rank holds)."""
        weight = np.zeros((len(idx),), np.float32)
        weight[:n_valid] = 1.0
        if self.rows is None:
            return idx, weight
        return idx[self.rows], weight[self.rows]

    @staticmethod
    def _assemble(lr: np.ndarray, hr: np.ndarray,
                  weight: np.ndarray) -> Dict[str, np.ndarray]:
        return {"lr": lr.astype(np.float32)[..., None] / 255.0,
                "hr": hr.astype(np.float32)[..., None] / 255.0,
                "weight": weight}


class BatchLoader(_LoaderBase):
    """In-memory epoch iterator over pre-decoded contiguous arrays — the
    small-dataset fast path (one decode for the whole run)."""

    def __init__(self, lr_array: np.ndarray, hr_array: np.ndarray,
                 indices: Sequence[int], batch_size: int,
                 shuffle: bool = True, seed: int = 0, rows=None):
        super().__init__(indices, batch_size, shuffle, seed, rows)
        self.lr = lr_array
        self.hr = hr_array

    def epoch(self, epoch_idx: Optional[int] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        for idx, n_valid in self._epoch_index_batches(epoch_idx):
            idx, weight = self._rows_of(idx, n_valid)
            yield self._assemble(self.lr[idx], self.hr[idx], weight)


class StreamingBatchLoader(_LoaderBase):
    """Bounded-RAM epoch iterator: decodes each batch's PNGs on demand.

    Matches the reference DataLoader's lazy per-batch reads + worker
    parallelism (scripts/train.py:215-233, utils/dataset.py:119-134) the
    way: the native threaded PNG decoder (native/png_loader.cpp)
    decodes one BATCH per call, and a single background thread keeps a
    ``prefetch``-deep queue of ready batches ahead of the consumer — so
    peak host RAM is O((prefetch + 2) * batch) regardless of dataset size. Same
    ``epoch()`` contract and data order as :class:`BatchLoader`.
    """

    def __init__(self, dataset: PairedSliceDataset, indices: Sequence[int],
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 prefetch: int = 2, rows=None):
        super().__init__(indices, batch_size, shuffle, seed, rows)
        self.dataset = dataset
        self.prefetch = max(1, prefetch)
        self.decode_batch_calls = 0     # accounting (tests/telemetry)
        self._hr_hw: Optional[Tuple[int, int]] = None
        self._lr_hw: Optional[Tuple[int, int]] = None

    def _decode_one(self, paths: List[str],
                    hw: Optional[Tuple[int, int]]) -> np.ndarray:
        if hw is not None and native.get_lib() is not None:
            out = native.decode_batch(paths, hw)
            if out is not None:
                return out
        return np.stack([_imread_gray(p) for p in paths])

    def _decode(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        meta = [self.dataset.metadata[i] for i in idx]
        if self._hr_hw is None:
            self._hr_hw = native.png_size(meta[0]["full_res_path"])
            self._lr_hw = native.png_size(meta[0]["low_res_path"])
        hr = self._decode_one([m["full_res_path"] for m in meta], self._hr_hw)
        lr = self._decode_one([m["low_res_path"] for m in meta], self._lr_hw)
        self.decode_batch_calls += 1
        return lr, hr

    def epoch(self, epoch_idx: Optional[int] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        batches = list(self._epoch_index_batches(epoch_idx))

        def worker():
            for idx, n_valid in batches:
                if stop.is_set():
                    return
                idx, weight = self._rows_of(idx, n_valid)
                lr, hr = self._decode(idx)
                item = self._assemble(lr, hr, weight)
                while not stop.is_set():      # bounded put, abandon-safe
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            while not stop.is_set():
                try:
                    q.put(None, timeout=0.1)  # end-of-epoch sentinel
                    return
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True,
                             name="StreamingBatchLoader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()       # unblocks an in-flight put if abandoned early
            t.join(timeout=5.0)
