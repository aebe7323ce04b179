"""The port's native batched PNG/JPEG decoder (``petastorm_tpu_torch/native``)
against the JAX package's, on cells made with numpy from a seed and encoded
with OpenCV. Both libraries come from the same C++ (the port keeps its own
copy), so every output is held to exact equality. Also: the library the
port builds on a host without libjpeg, libpng and libdeflate (the
configuration of the card's host), which still decodes the PNGs the codec
writes and refuses the rest with an error naming the missing library."""

import ctypes
import os
import sys

import numpy as np
import pytest

from petastorm_tpu.native import image_codec as jax_native
from petastorm_tpu_torch.codecs import CompressedImageCodec, image_routes
from petastorm_tpu_torch.errors import SchemaError
from petastorm_tpu_torch.native import build
from petastorm_tpu_torch.native import image_codec as native
from petastorm_tpu_torch.unischema import UnischemaField

import cv2  # noqa: E402  (both packages encode and fall back through it)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png(arr):
    ok, buf = cv2.imencode('.png', arr if arr.ndim == 2 else cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
    assert ok
    return buf.tobytes()


def _jpeg(arr, quality=85):
    ok, buf = cv2.imencode('.jpeg', arr if arr.ndim == 2 else cv2.cvtColor(arr, cv2.COLOR_RGB2BGR),
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    assert ok
    return buf.tobytes()


def _photo(rng, h, w):
    yy = np.linspace(0, 4 * np.pi, h)[:, None, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, 3)[None, None, :]
    base = np.sin(xx + phase) * 70 + np.cos(yy + phase * 0.5) * 60 + 128
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.fixture(scope='module')
def reduced_lib(tmp_path_factory):
    """The port's decoder built without libjpeg, libpng and libdeflate."""
    path = str(tmp_path_factory.mktemp('reduced') / 'libreduced.so')
    return native.bind(ctypes.CDLL(build.build_img(output=path,
                                                   without=('jpeg', 'png', 'deflate'))))


def _cells(seed=0):
    rng = np.random.default_rng(seed)
    imgs = [_photo(rng, int(rng.integers(20, 70)), int(rng.integers(20, 70))) for _ in range(6)]
    imgs.append(rng.integers(0, 256, (33, 21), dtype=np.uint8))
    imgs.append(rng.integers(0, 65536, (17, 23, 3), dtype=np.uint16))
    imgs.append(rng.integers(0, 65536, (9, 30), dtype=np.uint16))
    return imgs, [_png(im) for im in imgs]


def test_library_builds_into_the_build_dir_with_the_hosts_libraries():
    assert native.is_available()
    assert os.path.dirname(build.IMG_OUTPUT) == os.path.join(REPO, '.torch_build', 'native')
    assert not any(f.endswith('.so') for f in os.listdir(os.path.dirname(native.__file__)))
    # this host has all three; a fresh build is not rebuilt
    assert native.features() == {'libjpeg': True, 'libpng': True, 'inflate': 'libdeflate'}
    mtime = os.path.getmtime(build.IMG_OUTPUT)
    assert build.build_img() == build.IMG_OUTPUT
    assert os.path.getmtime(build.IMG_OUTPUT) == mtime
    with pytest.raises(ValueError, match='unknown libraries'):
        build.build_img(without=('webp',))


def test_decode_images_matches_jax_on_png():
    imgs, cells = _cells()
    out = native.decode_images(cells)
    ref = jax_native.decode_images(cells)
    for a, b, im in zip(out, ref, imgs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, im)  # PNG is lossless


@pytest.mark.parametrize('min_size', [None, (16, 16), (40, 30), (200, 200)])
def test_scaled_jpeg_decode_matches_jax(min_size):
    rng = np.random.default_rng(1)
    cells = [_jpeg(_photo(rng, h, w)) for h, w in ((120, 90), (64, 200), (37, 41))]
    cells.append(_jpeg(rng.integers(0, 256, (50, 60), dtype=np.uint8)))
    out = native.decode_images(cells, min_size=min_size)
    ref = jax_native.decode_images(cells, min_size=min_size)
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # 120x90 at the smallest m/8 covering the hint: 2/8 -> ceil(30), ceil(22.5)
    expected = {None: (120, 90), (16, 16): (30, 23), (40, 30): (45, 34), (200, 200): (120, 90)}
    assert out[0].shape == expected[min_size] + (3,)


def test_decode_images_auto_layouts_match_jax():
    rng = np.random.default_rng(2)
    same = [_png(_photo(rng, 24, 32)) for _ in range(5)]
    block = native.decode_images_auto(same)
    assert isinstance(block, np.ndarray) and block.shape == (5, 24, 32, 3)
    np.testing.assert_array_equal(block, jax_native.decode_images_auto(same))
    _, mixed = _cells(3)
    out = native.decode_images_auto(mixed)
    ref = jax_native.decode_images_auto(mixed)
    assert isinstance(out, list) and len(out) == len(ref)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('size', [(32, 32), (10, 12), (90, 15)])
def test_decode_images_resized_matches_jax(size):
    rng = np.random.default_rng(4)
    cells = [_png(_photo(rng, int(rng.integers(20, 70)), int(rng.integers(20, 70))))
             for _ in range(7)] + [_jpeg(_photo(rng, 150, 110))]
    out = native.decode_images_resized(cells, size)
    np.testing.assert_array_equal(out, jax_native.decode_images_resized(cells, size))
    assert out.shape == (8,) + size + (3,)
    # 16-bit or mixed channel counts decline to the per-image path in both
    _, mixed = _cells(5)
    assert native.decode_images_resized(mixed, size) is None
    assert jax_native.decode_images_resized(mixed, size) is None


@pytest.mark.parametrize('size', [(13, 17), (30, 40), (64, 80), (20, 70)])
def test_standalone_resamplers_match_jax(size):
    img = _photo(np.random.default_rng(6), 40, 50)
    for name in ('resize_area_image', 'resize_bilinear_image'):
        np.testing.assert_array_equal(getattr(native, name)(img, size),
                                      getattr(jax_native, name)(img, size))


@pytest.mark.parametrize('cell', [b'', b'not an image at all', b'\x89PNG\r\n\x1a\n' + b'\0' * 40],
                         ids=['empty', 'garbage', 'truncated-png'])
def test_bad_cells_raise_at_the_same_index(cell):
    good = _png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(native.NativeDecodeError) as ours:
        native.decode_images([good, cell])
    with pytest.raises(jax_native.NativeDecodeError) as theirs:
        jax_native.decode_images([good, cell])
    assert ours.value.index == theirs.value.index == 1


def test_palette_png_is_refused_then_decoded_by_cv2():
    # a palette image (what cv2 writes for a 1-channel image with an
    # alpha-less palette is not reachable; build one with PIL)
    from PIL import Image
    import io
    buf = io.BytesIO()
    Image.fromarray(np.arange(48, dtype=np.uint8).reshape(6, 8)).convert('P').save(buf, 'PNG')
    with pytest.raises(native.NativeDecodeError):
        native.decode_images([buf.getvalue()])
    field = UnischemaField('image', np.uint8, (None, None, 3), CompressedImageCodec('png'))
    image_routes.reset()
    out = field.codec.decode_batch(field, [buf.getvalue()])
    assert out[0].shape[:2] == (6, 8)
    counts = image_routes.snapshot()
    assert counts['decode_fallback'] == counts['decode_cv2'] == 1 and not counts['decode_native']


def test_reduced_build_decodes_png_and_names_what_it_lacks(reduced_lib, monkeypatch):
    assert reduced_lib.pstpu_img_features() == 0
    monkeypatch.setattr(native, '_lib', reduced_lib)
    assert native.features() == {'libjpeg': False, 'libpng': False, 'inflate': 'zlib'}
    imgs, cells = _cells(7)
    for a, im in zip(native.decode_images(cells), imgs):  # zlib inflate: same bytes
        np.testing.assert_array_equal(a, im)
    np.testing.assert_array_equal(native.decode_images_resized(cells[:6], (24, 24)),
                                  jax_native.decode_images_resized(cells[:6], (24, 24)))
    jpeg = _jpeg(_photo(np.random.default_rng(8), 30, 40))
    with pytest.raises(native.NativeDecodeError, match='libjpeg') as err:
        native.decode_images([cells[0], jpeg])
    assert err.value.index == 1
    from PIL import Image
    import io
    buf = io.BytesIO()
    Image.fromarray(imgs[0][..., 0] > 128).save(buf, 'PNG')
    assert buf.getvalue()[24:26] == b'\x01\x00'  # 1-bit gray: libpng's to expand
    with pytest.raises(native.NativeDecodeError, match='libpng'):
        native.decode_images([buf.getvalue()])
    monkeypatch.undo()
    np.testing.assert_array_equal(native.decode_images([buf.getvalue()])[0],
                                  jax_native.decode_images([buf.getvalue()])[0])


def test_reduced_build_codec_falls_back_to_cv2_then_names_both(reduced_lib, monkeypatch):
    monkeypatch.setattr(native, '_lib', reduced_lib)
    rng = np.random.default_rng(9)
    photos = [_photo(rng, 40, 50) for _ in range(3)]
    cells = [_jpeg(p) for p in photos]
    field = UnischemaField('image', np.uint8, (None, None, 3), CompressedImageCodec('jpeg'))
    image_routes.reset()
    out = field.codec.decode_batch(field, cells, resize=(20, 25))
    ref = [cv2.resize(cv2.cvtColor(cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_COLOR),
                                   cv2.COLOR_BGR2RGB), (25, 20), interpolation=cv2.INTER_LINEAR)
           for c in cells]
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    counts = image_routes.snapshot()
    assert counts == {'decode_native': 0, 'decode_cv2': 3, 'decode_fallback': 3,
                      'resize_cv2': 3, 'resize_native': 0, 'resize_numpy': 0}
    # no cv2 either: the error names both routes, and no pixels come back
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(SchemaError, match='libjpeg.*OpenCV'):
        field.codec.decode_batch(field, cells)


def test_chip_smoke_png_writer_runs_every_filter():
    # chip_smoke.py writes PNGs with numpy and zlib, rows filtered None, Sub,
    # Up, Average and Paeth in turn; both decoders read them back exactly
    sys.path.insert(0, REPO)
    try:
        from chip_smoke import png_bytes
    finally:
        sys.path.remove(REPO)
    rng = np.random.default_rng(10)
    imgs = [_photo(rng, 23, 31), rng.integers(0, 256, (11, 7), dtype=np.uint8),
            rng.integers(0, 65536, (12, 5, 3), dtype=np.uint16),
            rng.integers(0, 65536, (6, 13), dtype=np.uint16)]
    for img in imgs:
        cell = png_bytes(img)
        np.testing.assert_array_equal(native.decode_images([cell])[0], img)
        dec = cv2.imdecode(np.frombuffer(cell, np.uint8), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(dec if dec.ndim == 2 else cv2.cvtColor(dec, cv2.COLOR_BGR2RGB),
                                      img)


def test_thread_budget_cooperative_grants(monkeypatch):
    monkeypatch.setattr(native, '_default_threads', lambda: 4)
    with native._thread_grant(None) as g1:
        assert g1 == 4
        with native._thread_grant(None) as g2:
            assert g2 == 1  # budget exhausted: the floor keeps the caller moving
    with native._thread_grant(None) as g3:
        assert g3 == 4  # fully returned
    with native._thread_grant(2) as g4:
        assert g4 == 2  # an explicit request bypasses the accounting
    assert native._threads_in_use == 0


def test_thread_budget_under_concurrent_decodes(monkeypatch):
    """More decoding threads than cores, each call taking a grant: every
    result equals the single-threaded decode and every grant is returned."""
    import threading
    monkeypatch.setattr(native, '_default_threads', lambda: 3)
    _, cells = _cells(11)
    cells = cells[:6]
    expected = native.decode_images(cells, threads=1)
    errors = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def work():
        for _ in range(20):
            for a, b in zip(native.decode_images(cells), expected):
                if not np.array_equal(a, b):
                    errors.append('mismatch')

    try:
        threads = [threading.Thread(target=work) for _ in range(2 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert native._threads_in_use == 0


def test_default_thread_budget(monkeypatch):
    monkeypatch.setenv('PSTPU_IMG_THREADS', 'auto')
    assert native._default_threads() == 1
    monkeypatch.setenv('PSTPU_IMG_THREADS', '6')
    assert native._default_threads() == 6
    monkeypatch.delenv('PSTPU_IMG_THREADS')
    assert native._default_threads() == max(1, os.cpu_count() or 1)
