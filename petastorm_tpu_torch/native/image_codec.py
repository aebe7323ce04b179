"""ctypes bindings for the batched PNG/JPEG decoder (image_codec.cpp).

Twin of ``petastorm_tpu/native/image_codec.py``, bound to the port's own copy
of the source. One native call decodes a whole column's worth of encoded
image cells with the GIL released (ctypes drops it for the whole call), so
the reader's thread pool decodes row groups in parallel. Any build or load
failure makes :func:`is_available` False and ``CompressedImageCodec`` takes
its per-image OpenCV path. A library built without some image library
(:func:`features`) refuses that format with a :class:`NativeDecodeError`
naming the library.

Threading: ``PSTPU_IMG_THREADS`` is the per-PROCESS native decode thread
budget (default: CPU count), shared cooperatively across concurrent calls
(:func:`_thread_grant`): a lone caller (dummy pool, benchmark) fans its
column out across all idle cores, while a full worker pool's concurrent calls
each take the free remainder (floor 1), so total decode threads stay near the
budget instead of pool width x budget. ``threads=N`` bypasses the accounting.
Sibling processes cannot see each other's grants, so each worker process of
a process pool gets an equal share of the cores through ``PSTPU_IMG_THREADS``
(set by the pool at spawn unless the user set it).
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import os
import threading

import numpy as np

logger = logging.getLogger(__name__)

_lib = None
_lib_lock = threading.Lock()
_load_failed = False


class NativeDecodeError(RuntimeError):
    """Native probe/decode refused the payload; callers fall back to OpenCV."""

    def __init__(self, message, index=None):
        super().__init__(message)
        self.index = index


def bind(lib):
    """Declare the C signatures on a loaded library; returns it."""
    lib.pstpu_img_last_error.restype = ctypes.c_char_p
    lib.pstpu_img_features.restype = ctypes.c_int32
    lib.pstpu_img_features.argtypes = []
    lib.pstpu_img_probe_batch2.restype = ctypes.c_int64
    lib.pstpu_img_probe_batch2.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32]
    lib.pstpu_img_decode_batch2.restype = ctypes.c_int64
    lib.pstpu_img_decode_batch2.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32]
    lib.pstpu_img_decode_resize_batch.restype = ctypes.c_int64
    lib.pstpu_img_decode_resize_batch.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    for name in ('pstpu_img_resize_area', 'pstpu_img_resize_bilinear'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
    return lib


def _load_library():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            from petastorm_tpu_torch.native.build import build_img
            lib = ctypes.CDLL(build_img())
        except (OSError, RuntimeError) as e:  # no compiler, or a failed build/load
            logger.info('native image codec unavailable (%s); using OpenCV per-image decode', e)
            _load_failed = True
            return None
        _lib = bind(lib)
        return _lib


def is_available():
    return _load_library() is not None


def batch_fn_addrs():
    """C addresses of ``pstpu_img_probe_batch2`` and
    ``pstpu_img_decode_batch2``, for the fused row-group kernel
    (``pstpu_read_fused``) to call through: images then decode inside the
    same native call as the page walk, with no link between the two
    libraries. ``(probe_addr, decode_addr)``, or None when the decoder is
    unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    return (ctypes.cast(lib.pstpu_img_probe_batch2, ctypes.c_void_p).value,
            ctypes.cast(lib.pstpu_img_decode_batch2, ctypes.c_void_p).value)


def features():
    """What the loaded library decodes with: ``{'libjpeg': bool, 'libpng':
    bool, 'inflate': 'libdeflate' or 'zlib'}``; ``None`` when unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    bits = lib.pstpu_img_features()
    return {'libjpeg': bool(bits & 1), 'libpng': bool(bits & 2),
            'inflate': 'libdeflate' if bits & 4 else 'zlib'}


def _default_threads():
    """The per-PROCESS native decode thread budget (``PSTPU_IMG_THREADS``).

    Unset: CPU count in a top-level process; 1 in a multiprocessing child
    (sibling processes cannot see each other's grants). Set but unparseable
    degrades to 1, never to the full budget."""
    raw = os.environ.get('PSTPU_IMG_THREADS')
    if raw is not None:
        try:
            return max(1, int(raw))
        except ValueError:
            return 1
    import multiprocessing
    if multiprocessing.parent_process() is not None:
        return 1
    return max(1, os.cpu_count() or 1)


_budget_lock = threading.Lock()
_threads_in_use = 0


@contextlib.contextmanager
def _thread_grant(requested):
    """Cooperative intra-call fan-out: ``requested=None`` takes whatever share
    of the process-wide budget is free (floor 1, so callers never block) and
    returns it afterwards. The floor means N concurrent callers can hold
    budget + (N - 1) threads at most. An explicit integer bypasses the
    accounting."""
    if requested is not None:
        yield max(1, int(requested))
        return
    global _threads_in_use
    budget = _default_threads()
    with _budget_lock:
        grant = max(1, budget - _threads_in_use)
        _threads_in_use += grant
    try:
        yield grant
    finally:
        with _budget_lock:
            _threads_in_use -= grant


def _error(lib):
    return lib.pstpu_img_last_error().decode(errors='replace')


def _probe(buffers, min_w, min_h):
    """``(lib, views, ptrs, lens, infos)`` of one batched header probe; the
    views keep the cells' memory alive for the decode call."""
    lib = _load_library()
    if lib is None:
        raise NativeDecodeError('native image codec not available')
    n = len(buffers)
    # numpy views give stable base addresses for arbitrary (read-only) buffers
    views = [np.frombuffer(b, dtype=np.uint8) for b in buffers]
    ptrs = (ctypes.c_void_p * n)(*[v.ctypes.data for v in views])
    lens = (ctypes.c_uint64 * n)(*[v.size for v in views])
    infos = np.empty((n, 4), dtype=np.int32)
    rc = lib.pstpu_img_probe_batch2(n, ptrs, lens,
                                    infos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                    min_w, min_h)
    if rc != -1:
        raise NativeDecodeError('image at index {} refused: {}'.format(rc, _error(lib)),
                                index=rc)
    return lib, views, ptrs, lens, infos


def _decode_into(lib, ptrs, lens, infos, out_ptrs, threads, min_w, min_h):
    infos_p = infos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    with _thread_grant(threads) as fanout:
        rc = lib.pstpu_img_decode_batch2(len(infos), ptrs, lens, out_ptrs, infos_p, fanout,
                                         min_w, min_h)
    if rc != -1:
        raise NativeDecodeError('image decode failed at index {}: {}'.format(rc, _error(lib)),
                                index=rc)


def _image_array(info, lead=()):
    w, h, c, depth = (int(x) for x in info)
    return np.empty(lead + ((h, w) if c == 1 else (h, w, c)),
                    dtype=np.uint16 if depth == 16 else np.uint8)


def decode_images(buffers, threads=None, min_size=None):
    """Decode a list of encoded PNG/JPEG cells (bytes/memoryview) in one native
    call. Returns a list of numpy arrays: ``(H, W)`` for grayscale,
    ``(H, W, 3)`` RGB otherwise; uint8, or uint16 for 16-bit PNG.

    ``min_size=(min_h, min_w)`` enables scaled JPEG decode: each JPEG comes out
    at the smallest libjpeg m/8 DCT scale whose dims still cover the minimum
    (full size if the image is already smaller). PNGs ignore the hint.

    Raises :class:`NativeDecodeError` when any cell is an unsupported flavor
    (palette/alpha PNG, CMYK JPEG, corrupt data, a format the build lacks)."""
    if not buffers:
        return []
    min_h, min_w = (int(min_size[0]), int(min_size[1])) if min_size else (0, 0)
    lib, _views, ptrs, lens, infos = _probe(buffers, min_w, min_h)
    outs = [_image_array(info) for info in infos]
    out_ptrs = (ctypes.c_void_p * len(outs))(*[a.ctypes.data for a in outs])
    _decode_into(lib, ptrs, lens, infos, out_ptrs, threads, min_w, min_h)
    return outs


def decode_images_auto(buffers, threads=None, min_size=None):
    """Decode a column of image cells with ONE header probe, into the best
    layout the column admits: one ``[N, H, W(, C)]`` array when every cell
    probes to the same dims and depth (the per-image out pointers walk the
    rows of one allocation), else a list of per-image arrays as
    :func:`decode_images` gives. Raises :class:`NativeDecodeError` like it."""
    if not buffers:
        return []
    n = len(buffers)
    min_h, min_w = (int(min_size[0]), int(min_size[1])) if min_size else (0, 0)
    lib, _views, ptrs, lens, infos = _probe(buffers, min_w, min_h)
    if n == 1 or not (infos != infos[0]).any():
        result = _image_array(infos[0], lead=(n,))
        stride, base = result.strides[0], result.ctypes.data
        out_ptrs = (ctypes.c_void_p * n)(*[base + i * stride for i in range(n)])
    else:
        result = [_image_array(info) for info in infos]
        out_ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in result])
    _decode_into(lib, ptrs, lens, infos, out_ptrs, threads, min_w, min_h)
    return result


def decode_images_block(buffers, threads=None, min_size=None):
    """:func:`decode_images_auto` held to the one-array layout: the
    ``[N, H, W(, C)]`` array, or ``None`` when the cells' dims differ."""
    result = decode_images_auto(buffers, threads=threads, min_size=min_size)
    return result if isinstance(result, np.ndarray) else None


def _resize_native(img, size, symbol_name):
    lib = _load_library()
    if lib is None:
        raise NativeDecodeError('native image codec not available')
    if img.dtype != np.uint8:
        raise ValueError('native resize supports uint8, got {}'.format(img.dtype))
    out_h, out_w = int(size[0]), int(size[1])
    c = img.shape[2] if img.ndim == 3 else 1
    src = np.ascontiguousarray(img)
    out = np.empty((out_h, out_w) + ((c,) if img.ndim == 3 else ()), np.uint8)
    rc = getattr(lib, symbol_name)(src.ctypes.data, img.shape[1], img.shape[0], c,
                                   out.ctypes.data, out_w, out_h)
    if rc != 0:
        raise NativeDecodeError('native resize failed: {}'.format(_error(lib)))
    return out


def resize_area_image(img, size):
    """Area-resample one decoded uint8 image to ``size=(out_h, out_w)`` with
    the native resampler: the cv2 ``INTER_AREA`` stand-in where OpenCV is
    absent. Raises :class:`NativeDecodeError` when the library is
    unavailable."""
    return _resize_native(img, size, 'pstpu_img_resize_area')


def resize_bilinear_image(img, size):
    """Bilinear-resample one decoded uint8 image (half-pixel centers, cv2
    ``INTER_LINEAR`` semantics): the mild-ratio half of the shared resize
    policy (``codecs._resize_image``)."""
    return _resize_native(img, size, 'pstpu_img_resize_bilinear')


def decode_images_resized(buffers, size, threads=None, min_size=None):
    """Fused decode + resize of a whole column into ONE ``[N, out_h, out_w(,
    C)]`` allocation; ``size`` is ``(out_h, out_w)``. Each image decodes at its
    probed dims (JPEG: at the smallest m/8 DCT scale covering ``min_size``,
    default the target) and is resampled per the shared policy (bilinear below
    2x decimation, area at 2x and more) into its output row.

    Returns ``None`` when the column mixes channel counts or holds 16-bit
    images (callers take their per-image path); raises
    :class:`NativeDecodeError` for unsupported or corrupt cells."""
    n = len(buffers)
    if n == 0:
        return None
    out_h, out_w = int(size[0]), int(size[1])
    if out_h < 1 or out_w < 1:
        raise ValueError('resize target must be positive, got {}'.format(size))
    min_h, min_w = (int(min_size[0]), int(min_size[1])) if min_size else (out_h, out_w)
    lib, _views, ptrs, lens, infos = _probe(buffers, min_w, min_h)
    if (infos[:, 3] != 8).any() or (infos[:, 2] != infos[0, 2]).any():
        return None  # 16-bit or mixed gray/RGB column: per-image path
    c = int(infos[0, 2])
    out = np.empty((n, out_h, out_w) if c == 1 else (n, out_h, out_w, c), dtype=np.uint8)
    stride, base = out.strides[0], out.ctypes.data
    out_ptrs = (ctypes.c_void_p * n)(*[base + i * stride for i in range(n)])
    with _thread_grant(threads) as fanout:
        rc = lib.pstpu_img_decode_resize_batch(
            n, ptrs, lens, out_ptrs, infos.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            fanout, min_w, min_h, out_w, out_h)
    if rc != -1:
        raise NativeDecodeError('image decode+resize failed at index {}: {}'.format(
            rc, _error(lib)), index=rc)
    return out
