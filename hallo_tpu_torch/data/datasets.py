"""The training datasets (the port's copy of hallo_tpu/data/datasets.py's
`FaceMaskDataset`, `TalkingVideoDataset` and `batch_iterator`).

Reference: hallo/datasets/mask_image.py:21-154 (stage 1) and
talk_video.py:83-316 (stage 2). Items come from preprocessed .npz clips
(scripts/data_preprocess.py's format: frames, audio_emb, face_emb,
face_region and the {full, face, lip}_mask_{level} pyramids) and are
yielded as numpy batches in the layouts `train.step.make_train_step` takes:

    stage 1: pixel_values (B, 1, H, W, 3), ref_pixels (B, H, W, 3),
    face_emb (B, E), face_region (B, H, W, 3);
    stage 2: pixel_values (B, F, H, W, 3), ref_pixels (B, H, W, 3),
    motion_pixels (B, M, H, W, 3), audio_windows (B, F, 2m+1, blocks, C),
    face_emb (B, E), face_region (B, H, W, 3),
    masks 4 x (full, face, lip) each (B, L_d)

`batch_iterator` reads the clips ahead through the C++ prefetcher
(`data/native_prefetch.py`), in epoch order, so the items, their random
draws and the batches are the synchronous reads' bit for bit. Under data
and clip parallelism (`mesh`) every rank walks the same global order and
draws, decodes only its rows of each global batch (the others' draws are
taken from their files' array headers alone), and keeps its frames of
them.
"""

from __future__ import annotations

import json
import queue
import random
import threading
import zipfile
from typing import Dict, Iterator, List

import numpy as np


def _to_pm1(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) / 255.0 * 2.0 - 1.0


def npz_lengths(path: str, names) -> List[int]:
    """The leading dimension of arrays `names` of an .npz file, read from the
    arrays' headers alone (nothing is decompressed past them)."""
    out = []
    with zipfile.ZipFile(path) as zf:
        for name in names:
            with zf.open(f"{name}.npy") as fh:
                version = np.lib.format.read_magic(fh)
                read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
                out.append(int(read(fh)[0][0]))
    return out


class FaceMaskDataset:
    """Stage-1 items: a reference frame, a target frame at least
    `sample_margin` frames away, the face region and the face embedding
    (the clips are stored at the training size: JAX's unused `img_size` is
    not taken)."""

    def __init__(self, meta_paths: List[str], sample_margin: int = 30, seed: int = 0):
        self.meta: List[dict] = []
        for path in meta_paths:
            with open(path) as f:
                self.meta.extend(json.load(f))
        self.sample_margin = sample_margin
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.meta)

    def clip_path(self, idx: int) -> str:
        return self.meta[idx]["clip_path"]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.assemble(np.load(self.clip_path(idx)))

    def _draws(self, t: int):
        """(reference, target) frame indices of a clip of `t` frames."""
        ref_idx = self.rng.randrange(t)
        margin = min(self.sample_margin, t - 1)
        # the target at least `margin` away, wrapped (mask_image.py:103-112)
        if ref_idx + margin < t:
            tgt_idx = self.rng.randrange(ref_idx + margin, t)
        elif ref_idx - margin > 0:
            tgt_idx = self.rng.randrange(0, ref_idx - margin)
        else:
            tgt_idx = self.rng.randrange(t)
        return ref_idx, tgt_idx

    def skip(self, path: str) -> None:
        """Take the draws of the clip at `path` without building its item."""
        self._draws(*npz_lengths(path, ("frames",)))

    def assemble(self, clip) -> Dict[str, np.ndarray]:
        """Build the item from a clip's npz contents; the draws follow the
        JAX package's order (reference, then target)."""
        frames = clip["frames"]  # (T, H, W, 3) uint8
        ref_idx, tgt_idx = self._draws(len(frames))
        return dict(
            pixel_values=_to_pm1(frames[tgt_idx])[None],  # (1, H, W, 3)
            ref_pixels=_to_pm1(frames[ref_idx]),
            face_emb=clip["face_emb"].astype(np.float32),
            face_region=clip["face_region"].astype(np.float32),
        )


class TalkingVideoDataset:
    """Stage-2 items: a random window of `n_sample_frames` frames, the
    motion frames before it, audio windows and mask pyramids."""

    def __init__(
        self,
        meta_paths: List[str],
        n_sample_frames: int = 14,
        n_motion_frames: int = 2,
        audio_margin: int = 2,
        seed: int = 0,
    ):
        self.meta: List[dict] = []
        for path in meta_paths:
            with open(path) as f:
                self.meta.extend(json.load(f))
        self.n_sample_frames = n_sample_frames
        self.n_motion_frames = n_motion_frames
        self.audio_margin = audio_margin
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.meta)

    def clip_path(self, idx: int) -> str:
        return self.meta[idx]["clip_path"]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.assemble(np.load(self.clip_path(idx)))

    def _draws(self, t: int):
        """(window start, reference frame) of a clip of `t` frames."""
        lo = self.n_motion_frames + self.audio_margin
        hi = t - self.n_sample_frames - self.audio_margin
        start = self.rng.randrange(lo, max(hi, lo + 1))
        return start, self.rng.randrange(t)

    def skip(self, path: str) -> None:
        """Take the draws of the clip at `path` without building its item."""
        self._draws(min(npz_lengths(path, ("frames", "audio_emb"))))

    def assemble(self, clip) -> Dict[str, np.ndarray]:
        """Build the item from a clip's npz contents."""
        frames = clip["frames"]  # (T, H, W, 3) uint8
        audio = clip["audio_emb"]  # (T, blocks, C)
        t = min(len(frames), len(audio))
        f, m, margin = self.n_sample_frames, self.n_motion_frames, self.audio_margin
        start, ref_idx = self._draws(t)
        end = min(start + f, t - margin)
        idxs = np.arange(start, end)
        if len(idxs) < f:  # pad by repeating the last frame
            idxs = np.concatenate([idxs, np.repeat(idxs[-1:], f - len(idxs))])

        # audio windows: center +-margin gather (talk_video.py:243-250)
        centers = idxs[:, None] + np.arange(-margin, margin + 1)[None, :]
        centers = np.clip(centers, 0, t - 1)
        audio_windows = audio[centers]  # (F, 2m+1, blocks, C)

        motion = frames[max(start - m, 0):start]
        if len(motion) < m:
            motion = np.concatenate(
                [np.repeat(frames[:1], m - len(motion), axis=0), motion], axis=0
            )

        masks = tuple(
            tuple(clip[f"{kind}_mask_{level}"].reshape(-1).astype(np.float32)
                  for kind in ("full", "face", "lip"))
            for level in range(4)
        )
        return dict(
            pixel_values=_to_pm1(frames[idxs]),
            ref_pixels=_to_pm1(frames[ref_idx]),
            motion_pixels=_to_pm1(motion),
            audio_windows=audio_windows.astype(np.float32),
            face_emb=clip["face_emb"].astype(np.float32),
            face_region=clip["face_region"].astype(np.float32),
            masks=masks,
        )


def batch_iterator(
    dataset,
    batch_size: int,
    seed: int = 0,
    prefetch: bool = True,
    mesh=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless shuffling batch loader: one permutation per epoch, batches of
    `batch_size` items (a dataset smaller than a batch is sampled with
    replacement, so every epoch yields at least one batch). The tail of an
    epoch that does not fill a batch is always dropped.

    With `prefetch`, the epoch's clip files are read ahead by the C++
    `FilePrefetcher` in epoch order (hallo_tpu/data/datasets.py:153-220),
    and one background thread decodes them and builds the items with
    `dataset.assemble`, in that order and one batch ahead of the consumer:
    the thread is the only one to draw from the dataset's and the order's
    generators while the iterator runs. A file that cannot be read raises
    here; there is no synchronous fallback.

    With a `mesh` (`parallel.mesh.Mesh`), the global batch is `batch_size`
    x its data size (JAX's `train_bs * mesh.shape["data"]`,
    scripts/train_stage2.py:179), walked in the same seeded order by every
    rank: this rank builds its `batch_size` rows of each (the other rows'
    draws are taken with `dataset.skip`, from their files' headers, so that
    every rank draws what one process would) and keeps its 1/seq of the
    frames of "pixel_values" and "audio_windows"."""
    if len(dataset) == 0:
        raise ValueError("batch_iterator: empty dataset")
    rng = np.random.default_rng(seed)
    n_data, d = (mesh.n_data, mesh.data_index) if mesh is not None else (1, 0)
    global_bs = batch_size * n_data

    def epoch_order():
        order = rng.permutation(len(dataset))
        if global_bs > len(order):
            reps = -(-global_bs // len(order))
            order = np.concatenate(
                [order] + [rng.permutation(len(dataset)) for _ in range(reps - 1)]
            )
        return order[: len(order) - len(order) % global_bs]

    def mine(pos: int) -> bool:
        return d * batch_size <= pos % global_bs < (d + 1) * batch_size

    def stream() -> Iterator[Dict[str, np.ndarray]]:
        """This rank's items of every epoch, in order."""
        while True:
            order = epoch_order()
            if not prefetch:
                for pos, j in enumerate(order):
                    if mine(pos):
                        yield dataset[int(j)]
                    else:
                        dataset.skip(dataset.clip_path(int(j)))
                continue
            from hallo_tpu_torch.data.native_prefetch import FilePrefetcher

            pf = FilePrefetcher([dataset.clip_path(int(j))
                                 for pos, j in enumerate(order) if mine(pos)])
            try:
                clips = pf.iter_npz()
                for pos, j in enumerate(order):
                    if mine(pos):
                        yield dataset.assemble(next(clips))
                    else:
                        dataset.skip(dataset.clip_path(int(j)))
            finally:
                pf.close()

    def collate(items):
        batch = {}
        for key in items[0]:
            if key == "masks":
                batch[key] = tuple(
                    tuple(np.stack([it[key][lvl][kind] for it in items]) for kind in range(3))
                    for lvl in range(4)
                )
            else:
                batch[key] = np.stack([it[key] for it in items])
                if mesh is not None and key in ("pixel_values", "audio_windows"):
                    f = batch[key].shape[1] // mesh.n_seq
                    batch[key] = batch[key][:, mesh.seq_index * f:(mesh.seq_index + 1) * f]
        return batch

    items = _in_background(stream(), depth=batch_size) if prefetch else stream()
    try:
        while True:
            yield collate([next(items) for _ in range(batch_size)])
    finally:
        items.close()


def _in_background(items: Iterator, depth: int) -> Iterator:
    """`items`, produced by one background thread up to `depth` ahead and
    consumed in order; an error in the thread is raised here. Closing the
    returned generator (or dropping it) stops the thread and closes
    `items`."""
    out: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(entry) -> bool:
        while not stop.is_set():
            try:
                out.put(entry, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce() -> None:
        error: BaseException = RuntimeError("batch_iterator: the reader thread ended")
        try:
            for item in items:
                if not put((item, None)):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            error = e
        finally:
            items.close()
            put((None, error))

    thread = threading.Thread(target=produce, name="batch_iterator", daemon=True)
    thread.start()
    try:
        while True:
            item, error = out.get()
            if error is not None:
                raise error
            yield item
    finally:
        stop.set()
        thread.join()
