"""The loader's views on a pool of host threads
(``LoaderBase.load_grayscale_batch``), on the CPU, on JPEGs of mixed sizes
the test writes.

- The pooled batch and sizes equal the serial path's (one thread) bit for
  bit, with and without ``pad_to``, with ``indices`` out of order and with
  the resize that ``max_resolution`` asks for; each view sits in its
  padded slot as the former one-view-at-a-time code made it
  (``astype``, ``/ 255``, ``r * 0.299 + g * 0.587 + b * 0.114``), zeros
  around it. ``rgb_to_gray`` gives the former bits in place (``out=``),
  on uint8 images of 0 and 1 (not scaled) and on every uint8 colour.
- The width follows ``torch.get_num_threads()``: ``POOL_READS`` counts the
  views read on the pool, ``SERIAL_READS`` those read in the caller (a
  one-view batch, or one thread).
- A missing file raises ``FileNotFoundError`` on either path.
- Under a CPU ``torch.profiler``: one ``load.read`` and one ``load.gray`` a
  view, children of the one ``load.pool``, itself a child of ``load``; the
  benchmark's ``decode_ms_per_image`` reader reads them; ``MAX_SPANS``
  and ``dropped()`` account for every span of a pool wider than the host
  with a short switch interval.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image as PILImage
from torch.profiler import ProfilerActivity, profile

from gtsfm_tpu_torch.common.image import rgb_to_gray
from gtsfm_tpu_torch.loader import base
from gtsfm_tpu_torch.utils import tracing
from tests.torch_threads import cap_threads

cap_threads()

SIZES = [(60, 80), (48, 90), (72, 64), (60, 80), (33, 51), (80, 40)]


class _Files(base.LoaderBase):
    def __init__(self, paths, max_resolution=760):
        super().__init__(max_resolution)
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def _get_image_full_res(self, index):
        return base.read_image(self.paths[index])


def _write(tmp_path, sizes, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for k, (h, w) in enumerate(sizes):
        p = str(tmp_path / f"{k:03d}.jpg")
        PILImage.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p, quality=95)
        paths.append(p)
    return paths


@contextlib.contextmanager
def _width(n):
    """torch's thread count, which sets the pool's width, at n."""
    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _gray_reference(rgb):
    """The former per-view conversion, temporaries and all."""
    arr = np.asarray(rgb).astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.ndim == 2:
        return arr
    return arr[..., 0] * 0.299 + arr[..., 1] * 0.587 + arr[..., 2] * 0.114


def _same_bits(a, b):
    return a.dtype == b.dtype == np.float32 and a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                                                    b.view(np.uint32))


@pytest.mark.parametrize("max_resolution", [760, 45])
@pytest.mark.parametrize("indices", [None, [4, 0, 5, 2, 1]])
@pytest.mark.parametrize("pad_to", [None, (96, 100)])
def test_pooled_batch_equals_serial_bit_for_bit(tmp_path, pad_to, indices, max_resolution):
    loader = _Files(_write(tmp_path, SIZES), max_resolution)
    with _width(1):
        serial = loader.load_grayscale_batch(indices, pad_to=pad_to)
    pooled_before = base.POOL_READS
    with _width(4):
        pooled = loader.load_grayscale_batch(indices, pad_to=pad_to)
    order = list(range(len(SIZES))) if indices is None else indices
    assert base.POOL_READS - pooled_before == len(order)
    assert pooled[1] == serial[1] and _same_bits(pooled[0], serial[0])
    batch, sizes = pooled
    for b, i in enumerate(order):
        gray = _gray_reference(loader.get_image(i).value_array)
        h, w = gray.shape
        assert sizes[b] == (h, w)
        assert _same_bits(batch[b, :h, :w].copy(), gray)
        assert not batch[b, h:].any() and not batch[b, :, w:].any()
    H, W = max(s[0] for s in sizes), max(s[1] for s in sizes)
    if pad_to is not None:
        H, W = max(H, pad_to[0]), max(W, pad_to[1])
    assert batch.shape == (len(order), H, W)


@pytest.mark.parametrize("value", [
    np.random.default_rng(1).integers(0, 256, (23, 31, 3), dtype=np.uint8),
    np.random.default_rng(5).integers(0, 2, (23, 31, 3), dtype=np.uint8),
    np.random.default_rng(6).integers(0, 256, (23, 31, 4), dtype=np.uint8)[:, ::-1],
    np.random.default_rng(2).integers(0, 256, (23, 31), dtype=np.uint8),
    np.random.default_rng(3).random((23, 31, 3)),
    (np.random.default_rng(4).random((23, 31, 3)) * 3).astype(np.float32),
], ids=["rgb_u8", "rgb_u8_zero_one", "rgba_u8_strided", "gray_u8", "rgb_unit_f64", "rgb_f32"])
def test_rgb_to_gray_in_place_gives_the_same_bits(value):
    ref = _gray_reference(value)
    assert _same_bits(rgb_to_gray(value), ref)
    canvas = np.full((30, 40), 7.0, np.float32)
    out = rgb_to_gray(value, out=canvas[:23, :31])
    assert out.base is canvas and _same_bits(canvas[:23, :31].copy(), ref)
    assert (canvas[23:] == 7.0).all() and (canvas[:, 31:] == 7.0).all()


def test_rgb_to_gray_on_every_uint8_colour():
    """The uint8 path against the float32 formula on all 2**24 colours, a
    red value at a time."""
    g, b = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8), indexing="ij")
    rgb = np.stack([g, g, b], -1)
    for r in range(256):
        rgb[..., 0] = r
        assert _same_bits(rgb_to_gray(rgb), _gray_reference(rgb)), r


def test_width_follows_torch_threads(tmp_path):
    loader = _Files(_write(tmp_path, SIZES[:3]))
    for threads, indices, pooled, serial in ((4, [2], 0, 1), (1, None, 0, 3), (4, None, 3, 0), (2, [0, 1], 2, 0)):
        p0, s0 = base.POOL_READS, base.SERIAL_READS
        with _width(threads):
            loader.load_grayscale_batch(indices)
        assert (base.POOL_READS - p0, base.SERIAL_READS - s0) == (pooled, serial)


@pytest.mark.parametrize("threads", [1, 4])
def test_missing_file_raises_as_before(tmp_path, threads):
    paths = _write(tmp_path, SIZES[:3])
    os.remove(paths[1])
    with _width(threads), pytest.raises(FileNotFoundError):
        _Files(paths).load_grayscale_batch()


@pytest.fixture
def _empty_store():
    tracing.reset()
    yield
    tracing.reset()


def test_spans_of_a_pooled_load(tmp_path, _empty_store):
    from perfbench.metrics import decode_ms_per_image

    loader = _Files(_write(tmp_path, SIZES))
    with _width(3), profile(activities=[ProfilerActivity.CPU]):
        loader.load_grayscale_batch()
    names = {}
    for r in tracing.spans():
        names.setdefault(r["name"], []).append(r)
    (load,), (pool,) = names["load"], names["load.pool"]
    assert load["parent"] is None and pool["parent"] == load["id"] and pool["units"] == load["units"] == len(SIZES)
    for name in ("load.read", "load.gray"):
        assert len(names[name]) == len(SIZES) and {r["units"] for r in names[name]} == {1}
        assert {(r["parent"], r["root"]) for r in names[name]} == {(pool["id"], load["id"])}
        assert all(pool["start_ns"] <= r["start_ns"] <= r["end_ns"] <= pool["end_ns"] for r in names[name])
    assert set(names) == {"load", "load.pool", "load.read", "load.gray"} and tracing.dropped() == 0
    ms = decode_ms_per_image.read({})
    assert ms is not None and ms > 0


def test_span_bound_holds_across_pool_threads(tmp_path, monkeypatch, _empty_store):
    n = 24
    loader = _Files(_write(tmp_path, [(24, 32)] * n))
    with _width(1):
        serial = loader.load_grayscale_batch()
    monkeypatch.setattr(tracing, "MAX_SPANS", 20)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _width(2 * (os.cpu_count() or 1)), profile(activities=[ProfilerActivity.CPU]):
            pooled = loader.load_grayscale_batch()
    finally:
        sys.setswitchinterval(interval)
    assert _same_bits(pooled[0], serial[0])
    recorded = tracing.spans()
    assert len(recorded) == 20 and tracing.dropped() == 2 * n + 2 - 20  # read and gray a view, pool, load
    assert len({r["id"] for r in recorded}) == 20
