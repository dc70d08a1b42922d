"""The port's C++ file prefetcher (`csrc/prefetch.cpp` through
`data/native_prefetch.py`) and the prefetching `batch_iterator`, on the CPU.

The prefetcher's cases mirror tests/test_native_prefetch.py against the
port's copy: the build, order and content, a ring smaller than the worker
count, looping, npz decoding, a missing file. Where the JAX package falls
back to synchronous reads, the port raises: a build that fails and a
prefetcher the library refuses. `batch_iterator(prefetch=True)` gives the
synchronous path's batches and the JAX package's, bit for bit, over two
epochs of both datasets, including a dataset smaller than the batch.
"""

import os

import numpy as np
import pytest

from hallo_tpu.data import datasets as jax_datasets
from hallo_tpu_torch.data import datasets as tdatasets
from hallo_tpu_torch.data import native_prefetch
from hallo_tpu_torch.data.native_prefetch import FilePrefetcher, build_library

from tests.test_torch_train import _write_dataset


def test_build():
    path = build_library()
    assert os.path.isfile(path) and os.path.basename(path).startswith("prefetch-")
    assert os.path.dirname(path) == native_prefetch.BUILD_DIR  # never native/
    assert build_library() == path  # built once, then loaded as it is


def test_failed_build_raises(tmp_path):
    with pytest.raises(RuntimeError, match="could not start"):
        build_library(cxx=str(tmp_path / "no-such-compiler"), build_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="failed for prefetch.cpp"):
        build_library(cxx="false", build_dir=str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]


def test_refused_prefetcher_raises(tmp_path):
    """pf_open refuses an empty list or a ring of 0: JAX's binding then reads
    synchronously, the port's raises."""
    p = tmp_path / "x.bin"
    p.write_bytes(b"x")
    with pytest.raises(ValueError, match="pf_open refused"):
        FilePrefetcher([str(p)], capacity=0)
    with pytest.raises(ValueError, match="pf_open refused"):
        FilePrefetcher([])


def test_order_and_content(tmp_path):
    paths = []
    for i in range(5):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * (i + 1) * 100)
        paths.append(str(p))
    pf = FilePrefetcher(paths, capacity=2, workers=3)
    got = list(pf)
    pf.close()
    assert got == [bytes([i]) * (i + 1) * 100 for i in range(5)]


def test_capacity_smaller_than_workers(tmp_path):
    """Admission by the consumer's index window: with more workers than
    ring slots, the worker holding the next index is never shut out."""
    paths = []
    for i in range(64):
        p = tmp_path / f"s{i}.bin"
        p.write_bytes(bytes([i]) * (1 + (i * 37) % 300))
        paths.append(str(p))
    for _ in range(3):  # scheduling-dependent: a few rounds raise exposure
        pf = FilePrefetcher(paths, capacity=1, workers=4)
        got = list(pf)
        pf.close()
        assert [len(b) for b in got] == [1 + (i * 37) % 300 for i in range(64)]


def test_loop(tmp_path):
    p = tmp_path / "x.bin"
    p.write_bytes(b"abc")
    pf = FilePrefetcher([str(p)], capacity=2, workers=1, loop=True)
    it = iter(pf)
    for _ in range(7):
        assert next(it) == b"abc"
    pf.close()


def test_npz(tmp_path):
    p = tmp_path / "clip.npz"
    np.savez(p, frames=np.arange(12).reshape(3, 4), emb=np.ones(5))
    pf = FilePrefetcher([str(p)])
    items = list(pf.iter_npz())
    pf.close()
    np.testing.assert_array_equal(items[0]["frames"], np.arange(12).reshape(3, 4))
    np.testing.assert_array_equal(items[0]["emb"], np.ones(5))


def test_missing_file_raises(tmp_path):
    pf = FilePrefetcher([str(tmp_path / "nope.bin")])
    with pytest.raises(IOError, match="nope.bin"):
        list(pf)
    pf.close()


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if key == "masks":
            for lvl_a, lvl_b in zip(a[key], b[key]):
                for x, y in zip(lvl_a, lvl_b):
                    np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _datasets(meta, kind):
    if kind == "stage2":
        kw = dict(n_sample_frames=4, n_motion_frames=2, audio_margin=1, seed=3)
        return (tdatasets.TalkingVideoDataset([meta], **kw),
                tdatasets.TalkingVideoDataset([meta], **kw),
                jax_datasets.TalkingVideoDataset([meta], **kw))
    return (tdatasets.FaceMaskDataset([meta], sample_margin=4, seed=3),
            tdatasets.FaceMaskDataset([meta], sample_margin=4, seed=3),
            jax_datasets.FaceMaskDataset([meta], img_size=64, sample_margin=4, seed=3))


@pytest.mark.parametrize("kind", ["stage1", "stage2"])
@pytest.mark.parametrize("n_clips,batch", [(3, 2), (2, 3)])
def test_prefetched_batches_equal_synchronous_and_jax(tmp_path, kind, n_clips, batch):
    """Two epochs of batches (3 clips in batches of 2: one batch an epoch; 2 clips
    in batches of 3: sampled with replacement) from the prefetching reader,
    the synchronous one and the JAX package's synchronous one, bit for
    bit."""
    meta = _write_dataset(str(tmp_path), n_clips=n_clips, t=12)
    ours_pf, ours_sync, theirs = _datasets(meta, kind)
    it_pf = tdatasets.batch_iterator(ours_pf, batch, seed=5)
    it_sync = tdatasets.batch_iterator(ours_sync, batch, seed=5, prefetch=False)
    it_jax = jax_datasets.batch_iterator(theirs, batch, seed=5, prefetch=False)
    epochs = 2 * max(1, n_clips // batch)
    for _ in range(epochs):
        a, b, c = next(it_pf), next(it_sync), next(it_jax)
        _assert_batches_equal(a, b)
        _assert_batches_equal(a, c)
    it_pf.close()


def test_background_reader_keeps_order_under_thread_switches(tmp_path):
    """The reader thread and the consumer switched every microsecond: 8
    clips in batches of 3 over 6 epochs stay the synchronous reader's, and
    closing the iterator stops the thread."""
    import sys
    import threading

    meta = _write_dataset(str(tmp_path), n_clips=8, t=12)
    ours_pf, ours_sync, _ = _datasets(meta, "stage2")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        it_pf = tdatasets.batch_iterator(ours_pf, 3, seed=1)
        it_sync = tdatasets.batch_iterator(ours_sync, 3, seed=1, prefetch=False)
        for _ in range(12):
            _assert_batches_equal(next(it_pf), next(it_sync))
        it_pf.close()
    finally:
        sys.setswitchinterval(interval)
    assert not [t for t in threading.enumerate() if t.name == "batch_iterator"]


def test_prefetched_reader_raises_on_a_missing_clip(tmp_path):
    meta = _write_dataset(str(tmp_path), n_clips=2, t=12)
    os.remove(os.path.join(str(tmp_path), "clip1.npz"))
    ds = tdatasets.FaceMaskDataset([meta], sample_margin=4, seed=3)
    batches = tdatasets.batch_iterator(ds, 1, seed=0)
    with pytest.raises(IOError, match="clip1.npz"):
        for _ in range(2):  # one epoch
            next(batches)


class _Indices:
    """A dataset whose item i is {"i": i}."""

    def __len__(self):
        return 5

    def __getitem__(self, i):
        return {"i": np.array(i)}


def test_batch_iterator_drops_the_tail_of_each_epoch():
    """5 items in batches of 2: each epoch gives 2 batches of 4 distinct
    items, and the fifth is left out."""
    batches = tdatasets.batch_iterator(_Indices(), 2, seed=0, prefetch=False)
    for _ in range(3):  # epochs
        epoch = np.concatenate([next(batches)["i"] for _ in range(2)])
        assert len(set(epoch.tolist())) == 4
