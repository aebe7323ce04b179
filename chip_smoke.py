"""chip_smoke.py: the quickest proof that petastorm_tpu_torch runs on an NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card, its power limit, and the TF32 settings used;
2. kernel checks: every hand-written kernel of the main path against its plain
   PyTorch version on the card (shapes, types and tolerances below), and the
   times of both (CUDA events, median of 25 runs);
3. stores: a raw uint8 store, an ImageNet-shaped PNG store and, where the
   host can encode and decode JPEG, a JPEG store, written by the port's
   ``materialize_dataset`` from a seed;
4. decode checks: what the host offers for image decode (OpenCV, the image
   libraries' headers and shared objects) and what the port's native decoder
   built with; the route that decodes and the route that resizes each
   format; the native decoder against the images as written (PNG: exact) on
   256 store images and on PNGs written here with every row filter; each
   resize route against the plain route (the numpy resamplers' weights,
   applied in float64) within 1 LSB; the host's decode+resize rate on one
   core and on a pool of one thread per core;
5. paths, each a full-width ResNet-50 bf16 train step (1000 classes, batch 64,
   160 px, SGD 0.1 momentum 0.9, ``random_flip`` and ``normalize_images``
   inside it) fed by ``make_reader(output='columnar')`` (thread pool, one
   worker per core) -> ``TorchDataLoader`` (shuffle 512, seed 7) ->
   ``prefetch_to_device(size=2)``, 3 warm-up and 10 measured steps through
   ``pipeline_duty_cycle``, a fresh model from one seed each:

   - ``raw``: the raw store, no decode;
   - ``png``: the PNG store with ``TransformSpec(image_resize=160x160)`` and a
     batched label transform (crc32 of the synset id);
   - ``png_cached``: the same with ``cache_type='local-disk'``, after one
     epoch that fills the cache; its run must read every row group from it;
   - ``jpeg``: a JPEG store of 320-560 px photos, where the probe allows it
     (else one line says why it is skipped).

   The kernels' launch counts and the image route counts are set to 0 just
   before each path and read just after it: a kernel of the path that was
   not launched, or an image decoded or resized by a route other than the one
   the decode checks named, fails the run. The first staged batch of each path
   is checked against the store's rows, the losses for being finite and
   starting near log(1000);
6. profile: three more steps of the raw path under ``torch.profiler``, the
   device's busy time per step by kernel and its idle share;
7. model check: the trained model on the card (bf16) against a float32 copy
   of it on the CPU, on four images of the store;
8. a ``kernels`` line (per kernel: route, source, the TPU kernel it replaces,
   launches over all paths, max error, its time, the plain version's time,
   the least time the card could take and what bounds it), the card's name
   and power limit as ``nvidia-smi`` gives them, and last
   ``{"ok": true, "device": {...}}``.

No failure is caught: any exception ends the run with a non-zero exit code and
no result line. Without CUDA the run fails at once. The native decoder's
build, the Triton cache, the stores and the disk cache live under
``.torch_build/`` in the checkout.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(ROOT, '.torch_build')

IMAGE_SIZE = 160
NUM_CLASSES = 1000
BATCH = 64
ROWS = 1024
ROWS_PER_ROW_GROUP = 64
# the image stores: bench_duty.py's png and jpeg variants
IMAGES_PER_SYNSET = 32
IMAGE_ROWS_PER_ROW_GROUP = 16
PNG_DIMS = (64, 160)
JPEG_DIMS = (320, 560)
# store images the decode checks hold against the images as written
CHECK_IMAGES = 256
# where the paths put their batches
DEVICE_TYPE = 'cuda'
WARMUP_STEPS = 3
STEPS = 10
SEED = 7
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

TIMING_RUNS = 25
# device clock cycles the stream spins before a timed run: some milliseconds,
# longer than the host takes to enqueue the run's calls
HOLD_CYCLES = 10_000_000


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError('chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False')
    # the model computes in bf16; the float32 head and the checks below stay
    # in full float32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = nvidia_smi_line()
    emit({'phase': 'device', 'nvidia_smi': card, 'name': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda,
          'cudnn_allow_tf32': torch.backends.cudnn.allow_tf32,
          'matmul_allow_tf32': torch.backends.cuda.matmul.allow_tf32})
    return card


def cuda_ms(torch, fn, inputs, hold_device=True):
    """Median over TIMING_RUNS of the per-call time of ``fn`` over
    ``inputs`` in turn (enough distinct inputs that they do not all stay in
    the 50 MB L2 cache), on the device's clock.

    With ``hold_device`` the stream first spins for a few milliseconds, so
    the host has enqueued every call before the first one starts and the
    events time the device's work alone; without it, a call whose host-side
    launch is slower than its kernel is timed at the host's launch rate."""
    for x in inputs[:3]:
        fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hold_device:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for x in inputs:
            fn(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / len(inputs))
    return statistics.median(times)


def normalize_bound_ms(shape, in_dtype, out_dtype, torch):
    """Least time for the normalize function: each input byte read once and
    each output byte written once over HBM, against two float32 operations
    per element at the float32 peak."""
    n = math.prod(shape)
    c = shape[-1]
    in_size = torch.empty((), dtype=in_dtype).element_size()
    out_size = torch.empty((), dtype=out_dtype).element_size()
    bytes_ms = (n * (in_size + out_size) + 2 * c * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), 'bytes' if bytes_ms >= ops_ms else 'operations'


def phase_kernels(torch):
    """The Triton normalize against its plain version, then both timed at
    the main path's shape. Returns the kernels-line entry without launches."""
    from petastorm_tpu_torch.ops.kernels import normalize as nk

    dev = torch.device('cuda')
    gen = np.random.default_rng(0)
    checks = []
    cases = [((BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), torch.uint8, torch.bfloat16),
             ((BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), torch.uint8, torch.float32),
             ((2, 17, 224, 3), torch.uint8, torch.bfloat16),
             ((2, 17, 224, 3), torch.uint8, torch.float32),
             ((4, 32, 32, 3), torch.uint8, torch.bfloat16),
             ((1, 8, 128, 1), torch.uint8, torch.bfloat16),
             ((1, 8, 128, 1), torch.uint8, torch.float32),
             ((4, 32, 32, 3), torch.float32, torch.bfloat16),
             ((4, 32, 32, 3), torch.float32, torch.float32),
             ((IMAGE_SIZE, IMAGE_SIZE, 3), torch.uint8, torch.bfloat16)]
    main_err = None
    for shape, in_dtype, out_dtype in cases:
        c = shape[-1]
        if in_dtype == torch.uint8:
            host = torch.from_numpy(gen.integers(0, 256, shape, dtype=np.uint8))
        else:
            host = torch.from_numpy((gen.random(shape) * 255).astype(np.float32))
        images = host.to(dev)
        mean = torch.from_numpy(IMAGENET_MEAN[:c]).to(dev)
        inv_std = torch.from_numpy(1.0 / IMAGENET_STD[:c]).to(dev)
        out = nk.normalize_triton(images, mean, inv_std, out_dtype)
        torch.cuda.synchronize()
        ref = nk.normalize_reference(images, mean, inv_std, out_dtype)
        if out.dtype != out_dtype or out.shape != images.shape:
            raise AssertionError('normalize {} {}->{}: got {} {}'.format(
                shape, in_dtype, out_dtype, out.dtype, tuple(out.shape)))
        diff = (out.float() - ref.float()).abs()
        if out_dtype == torch.bfloat16:
            # the same float32 value rounded to bf16: at most one bf16 ulp
            # (2**-7 of the value's magnitude, 8 significand bits)
            tol = 2.0 ** -7 * ref.float().abs() + 1e-6
            tolerance = '1 bf16 ulp'
        else:
            tol = 1e-5 + 1e-5 * ref.float().abs()
            tolerance = 'atol 1e-5 + rtol 1e-5'
        ok = bool((diff <= tol).all())
        err = float(diff.max())
        checks.append({'shape': list(shape), 'in': str(in_dtype), 'out': str(out_dtype),
                       'max_abs_err': err, 'tolerance': tolerance, 'ok': ok})
        if not ok:
            raise AssertionError('normalize kernel disagrees with its plain version: {}'.format(
                checks[-1]))
        if shape == (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) and out_dtype == torch.bfloat16:
            main_err = err

    shape = (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
    inputs = [torch.from_numpy(gen.integers(0, 256, shape, dtype=np.uint8)).to(dev)
              for _ in range(16)]  # 79 MB of input: more than L2 holds
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
    inv_std = torch.from_numpy(1.0 / IMAGENET_STD).to(dev)

    def kernel(x):
        return nk.normalize_triton(x, mean, inv_std)

    def plain(x):
        return nk.normalize_reference(x, mean, inv_std)

    # in turns: plain, kernel, kernel, plain
    plain_ms = [cuda_ms(torch, plain, inputs)]
    kernel_ms = [cuda_ms(torch, kernel, inputs), cuda_ms(torch, kernel, inputs)]
    plain_ms.append(cuda_ms(torch, plain, inputs))
    # back to back without holding the device: the rate at which the host
    # can launch the wrapper, which is what a caller's loop sees
    host_rate_ms = cuda_ms(torch, kernel, inputs, hold_device=False)
    bound_ms, bound_by = normalize_bound_ms(shape, torch.uint8, torch.bfloat16, torch)
    emit({'phase': 'kernel_checks', 'kernel': 'normalize', 'checks': checks,
          'timing_shape': list(shape), 'ms_runs': kernel_ms, 'plain_ms_runs': plain_ms,
          'launch_rate_ms': host_rate_ms,
          # the bytes the bound counts, over the kernel's time
          'hbm_gb_per_s': bound_ms / statistics.median(kernel_ms) * HBM_BYTES_PER_S / 1e9})
    del inputs
    return [{'name': 'normalize', 'route': 'triton',
             'source': 'petastorm_tpu_torch/ops/kernels/normalize.py',
             'replaces': 'petastorm_tpu/ops/preprocess.py:43',
             'launches': None, 'max_abs_err': main_err,
             'ms': statistics.median(kernel_ms),
             'plain_ms': statistics.median(plain_ms),
             'bound_ms': bound_ms, 'bound_by': bound_by,
             # no single PyTorch call computes cast + per-channel
             # subtract-and-scale + cast
             'library_ms': None}]


def _photo(rng, h, w):
    """A photo-like image: smooth gradients and mild noise, made from ``rng``
    (pure noise would make PNG pick no row filters and decode unrealistically
    fast)."""
    yy = np.linspace(0, 4 * np.pi, h)[:, None, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, 3)[None, None, :]
    base = np.sin(xx + phase) * 70 + np.cos(yy + phase * 0.5) * 60 + 128
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def _image(index):
    """The raw store's image ``index``, made from a seed, so a batch can be
    checked against the rows it came from."""
    return _photo(np.random.default_rng([SEED, index]), IMAGE_SIZE, IMAGE_SIZE)


def build_store(url):
    from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('RawImagenet', [
        UnischemaField('image', np.uint8, (IMAGE_SIZE, IMAGE_SIZE, 3), RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    with materialize_dataset(url, schema, rows_per_row_group=ROWS_PER_ROW_GROUP,
                             compression='none') as writer:
        for i in range(ROWS):
            writer.write({'image': _image(i), 'label': np.int64(i % NUM_CLASSES)})


def check_batch(images, labels):
    """Every staged row is a row of the store: its image is one of those
    written under its label."""
    for image, label in zip(images, labels):
        candidates = range(int(label), ROWS, NUM_CLASSES)
        if not any(np.array_equal(image, _image(i)) for i in candidates):
            raise AssertionError('a staged image matches no stored row of label {}'.format(label))


# -- the image stores and their checks -----------------------------------------

def _png_chunk(kind, data):
    return (len(data).to_bytes(4, 'big') + kind + data
            + zlib.crc32(kind + data).to_bytes(4, 'big'))


def png_bytes(img):
    """A non-interlaced 8- or 16-bit gray or RGB PNG of ``img``, written with
    numpy and zlib, its rows filtered None, Sub, Up, Average, Paeth in turn,
    so that a decode runs every unfilter of the format."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = img.dtype.itemsize * 8
    raw = np.ascontiguousarray(img, dtype='>u2' if depth == 16 else np.uint8)
    raw = raw.reshape(h, -1).view(np.uint8).astype(np.int32)
    bpp = channels * depth // 8
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    # Paeth predicts from the original bytes only, so it vectorises
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    predictors = [np.zeros_like(raw), left, up, (left + up) // 2, paeth]
    rows = [bytes([y % 5]) + ((raw[y] - predictors[y % 5][y]) % 256).astype(np.uint8).tobytes()
            for y in range(h)]
    ihdr = (w.to_bytes(4, 'big') + h.to_bytes(4, 'big')
            + bytes([depth, 0 if channels == 1 else 2, 0, 0, 0]))
    return (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', ihdr)
            + _png_chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + _png_chunk(b'IEND', b''))


def _image_rows(dims):
    """ImageNet-shaped rows: ``IMAGES_PER_SYNSET`` images per synset, each of
    random height and width in ``dims``, in the order
    ``examples/imagenet/generate_petastorm_imagenet.py`` makes them."""
    rng = np.random.default_rng(SEED)
    for s in range(ROWS // IMAGES_PER_SYNSET):
        noun_id = 'n{:08d}'.format(s)
        for _ in range(IMAGES_PER_SYNSET):
            h, w = int(rng.integers(*dims)), int(rng.integers(*dims))
            yield {'noun_id': noun_id, 'text': 'synthetic synset {}'.format(s),
                   'image': _photo(rng, h, w)}


def build_image_store(url, image_format, dims, encoder):
    """An ImagenetSchema-shaped store (``noun_id``, ``text``, ``image``),
    ``IMAGE_ROWS_PER_ROW_GROUP`` rows per row group. ``encoder='numpy'``
    (PNG on a host without OpenCV) writes the cells with :func:`png_bytes`
    under the same ``compressed_image`` codec id. Returns the PNG store's
    images as written."""
    from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    class NumpyPngCodec(CompressedImageCodec):
        def encode(self, field, value):
            return png_bytes(value)

    codec = (NumpyPngCodec if encoder == 'numpy' else CompressedImageCodec)(image_format)
    schema = Unischema('ImagenetSchema', [
        UnischemaField('noun_id', np.str_, (), ScalarCodec(), False),
        UnischemaField('text', np.str_, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (None, None, 3), codec, False)])
    written = []
    with materialize_dataset(url, schema, rows_per_row_group=IMAGE_ROWS_PER_ROW_GROUP) as writer:
        for row in _image_rows(dims):
            writer.write(row)
            if image_format == 'png':
                written.append(row['image'])
    return written


def label_of(noun_id):
    return zlib.crc32(str(noun_id).encode()) % NUM_CLASSES


class LabelFromNounId(object):
    """The batched label transform of ``examples/imagenet/jax_resnet_example.py``:
    the image arrives resized by the decode worker, the label is crc32 of the
    synset id (module level, so it pickles)."""

    def __call__(self, block):
        labels = np.fromiter((label_of(n) for n in block['noun_id']), dtype=np.int64,
                             count=len(block['noun_id']))
        return {'image': block['image'], 'label': labels}


def image_transform():
    from petastorm_tpu_torch import TransformSpec
    from petastorm_tpu_torch.unischema import UnischemaField

    return TransformSpec(
        LabelFromNounId(),
        edit_fields=[UnischemaField('image', np.uint8, (IMAGE_SIZE, IMAGE_SIZE, 3), None, False),
                     UnischemaField('label', np.int64, (), None, False)],
        removed_fields=['noun_id', 'text'], batched=True,
        image_resize={'image': (IMAGE_SIZE, IMAGE_SIZE)})


def plain_resize(img, out_h, out_w):
    """The plain resize route: the port's numpy resamplers' weights under the
    shared policy, applied one axis at a time in float64 (the numpy route
    itself, ``_resample_numpy``, contracts both axes at once and takes
    seconds per image)."""
    from petastorm_tpu_torch.codecs import _area_weights, _bilinear_weights, _mild_ratio

    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    weights = _bilinear_weights if _mild_ratio(h, w, out_h, out_w) else _area_weights
    rows = _contract(weights(h, out_h), img.astype(np.float64))  # [out_h, w, ...]
    out = _contract(weights(w, out_w), rows.swapaxes(0, 1)).swapaxes(0, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _contract(weights, arr):
    """``weights [out, in]`` times ``arr [in, ...]`` over the few taps each
    output row has (a dense product would spend its time on zeros)."""
    nonzero = weights != 0
    first = nonzero.argmax(axis=1)
    last = weights.shape[1] - 1 - nonzero[:, ::-1].argmax(axis=1)
    rows = np.arange(len(weights))
    out = np.zeros((len(weights),) + arr.shape[1:])
    for k in range(int((last - first).max()) + 1):
        idx = np.minimum(first + k, weights.shape[1] - 1)
        tap = np.where(first + k <= last, weights[rows, idx], 0.0).astype(np.float64)
        out += tap.reshape((-1,) + (1,) * (arr.ndim - 1)) * arr[idx]
    return out


def _max_err(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _resize_errors(outs, refs):
    return {'max_abs_err': max(_max_err(o, r) for o, r in zip(outs, refs)), 'images': len(outs),
            'differing_values': sum(int((o != r).sum()) for o, r in zip(outs, refs)),
            'values': sum(r.size for r in refs)}


def _host_cpu():
    model = 'unknown'
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    model = line.split(':', 1)[1].strip()
                    break
    except OSError:
        pass
    return {'cpu_model': model, 'cpu_count': os.cpu_count()}


def probe_host():
    """What the host offers for image decode, and what the port's native
    decoder built with. Decides the routes the paths must take."""
    from petastorm_tpu_torch.native import image_codec

    found = {}
    for module in ('cv2', 'PIL'):
        try:
            found[module] = __import__(module).__version__
        except ImportError:
            found[module] = None
    headers = {h: os.path.exists(os.path.join('/usr/include', h))
               for h in ('jpeglib.h', 'png.h', 'libdeflate.h', 'zlib.h')}
    ldconfig = subprocess.run(['ldconfig', '-p'], capture_output=True, text=True, timeout=60)
    libs = sorted({line.split()[0] for line in ldconfig.stdout.splitlines()
                   if any(k in line for k in ('libjpeg', 'libpng', 'libdeflate', 'libz.'))})
    t0 = time.perf_counter()
    features = image_codec.features()  # builds the library at first use
    build_s = time.perf_counter() - t0
    if features is None:
        png_decode = 'cv2' if found['cv2'] else None
    else:
        png_decode = 'native'
    if features is not None and features['libjpeg']:
        jpeg_decode = 'native'
    else:
        jpeg_decode = 'cv2' if found['cv2'] else None
    resize = 'cv2' if found['cv2'] else ('native' if features is not None else 'numpy')
    probe = {'modules': found, 'headers': headers, 'shared_objects': libs,
             'native': features, 'native_build_s': build_s,
             'encoder': 'cv2' if found['cv2'] else 'numpy',
             'routes': {'png': {'decode': png_decode, 'resize': resize},
                        # JPEG needs an encoder (cv2) for the store and a decoder
                        'jpeg': ({'decode': jpeg_decode, 'resize': resize}
                                 if found['cv2'] and jpeg_decode else None)}}
    if png_decode is None:
        raise AssertionError('no PNG decode route on this host: {}'.format(probe))
    return probe


def _store_cells(url, count):
    """The first ``count`` image cells of a store, as written, and the
    ``compressed_image`` field that decodes them."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl import get_schema

    path = os.path.join(url[len('file://'):], 'part-00000.parquet')
    table = pq.ParquetFile(path).read_row_groups(
        range(-(-count // IMAGE_ROWS_PER_ROW_GROUP)), columns=['image'])
    return table.column('image').slice(0, count), get_schema(url).fields['image']


def _decode_rate(field, column, threads):
    """Images per second of the slice's decode+resize (the codec's
    ``decode_column`` with the resize target), row group by row group as the
    reader's workers run it, on ``threads`` threads."""
    import concurrent.futures

    import pyarrow as pa

    from petastorm_tpu_torch.codecs import image_routes

    groups = [pa.chunked_array([column.slice(i, IMAGE_ROWS_PER_ROW_GROUP).combine_chunks()])
              for i in range(0, len(column), IMAGE_ROWS_PER_ROW_GROUP)]

    def decode(group):
        block = field.codec.decode_column(field, group, min_size=(IMAGE_SIZE, IMAGE_SIZE),
                                          resize=(IMAGE_SIZE, IMAGE_SIZE))
        if block is None:  # the native route refused: the per-image route
            block = field.codec.decode_batch(field, group.to_pylist(),
                                             resize=(IMAGE_SIZE, IMAGE_SIZE))
        return len(block)

    work = groups * max(1, threads)
    image_routes.reset()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        done = sum(pool.map(decode, work))
    seconds = time.perf_counter() - t0
    return {'threads': threads, 'images': done, 'images_per_s': done / seconds,
            'ms_per_batch_of_64': seconds / done * BATCH * 1e3 * threads,
            'routes': image_routes.snapshot()}


def phase_decode_checks(png_url, png_images, jpeg_url, probe):
    """The port's image decode and resize routes against plain routes, and
    the host's decode+resize rate. Tolerances: decode exact (PNG is
    lossless); resize within 1 LSB of the plain route, the bound the JAX
    package states for its native resampler against cv2."""
    from petastorm_tpu_torch.codecs import (_area_resize_numpy, _bilinear_resize_numpy,
                                            _mild_ratio, _resize_image, image_routes)
    from petastorm_tpu_torch.native import image_codec

    native = probe['native'] is not None
    column, field = _store_cells(png_url, CHECK_IMAGES)
    checks = {}
    # decode: the reader's route on 256 store images, then every row filter,
    # gray and RGB, 8 and 16 bits
    image_routes.reset()
    decoded = field.codec.decode_column(field, column)
    if decoded is None:
        decoded = field.codec.decode_batch(field, column.to_pylist())
    exact = all(np.array_equal(a, b) for a, b in zip(decoded, png_images[:CHECK_IMAGES]))
    checks['store_png'] = {'images': CHECK_IMAGES, 'exact': exact,
                           'routes': image_routes.snapshot()}
    if not exact or len(decoded) != CHECK_IMAGES:
        raise AssertionError('decoded store images differ from the images written')
    gen = np.random.default_rng(SEED)
    filtered = [gen.integers(0, 256, (37, 50, 3), dtype=np.uint8),
                gen.integers(0, 256, (20, 33), dtype=np.uint8),
                gen.integers(0, 65536, (18, 21, 3), dtype=np.uint16),
                gen.integers(0, 65536, (9, 15), dtype=np.uint16),
                png_images[0]]
    cells = [png_bytes(img) for img in filtered]
    if native:
        out = image_codec.decode_images(cells)
        checks['filters_native_exact'] = all(np.array_equal(a, b) for a, b in zip(out, filtered))
    if probe['modules']['cv2']:
        import cv2
        out = [cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_UNCHANGED) for c in cells]
        out = [cv2.cvtColor(o, cv2.COLOR_BGR2RGB) if o.ndim == 3 else o for o in out]
        # OpenCV reads the same bytes: the encoder above writes valid PNGs
        checks['filters_cv2_exact'] = all(np.array_equal(a, b) for a, b in zip(out, filtered))
    if not all(v for k, v in checks.items() if k.startswith('filters')):
        raise AssertionError('filtered PNGs decode wrong: {}'.format(checks))

    # resize: each route against the plain route, upscale (the png path's
    # 160 px) and decimation (48 px: area where an axis shrinks 2x or more)
    images = png_images[:CHECK_IMAGES]
    resize = {}
    for target in ((IMAGE_SIZE, IMAGE_SIZE), (48, 48)):
        plain = [plain_resize(img, *target) for img in images]
        routes = {'policy_' + probe['routes']['png']['resize']:
                  [_resize_image(img, *target) for img in images]}
        if native:
            routes['native'] = [
                (image_codec.resize_bilinear_image if _mild_ratio(*img.shape[:2], *target)
                 else image_codec.resize_area_image)(img, target) for img in images]
            routes['native_fused'] = list(image_codec.decode_images_resized(
                column.to_pylist(), target))
        for name, outs in routes.items():
            resize['{}x{}_{}'.format(*target, name)] = _resize_errors(outs, plain)
    # the numpy route itself takes seconds per image: one small image, area
    # down and bilinear up
    small, targets = filtered[0], ((24, 24), (60, 90))
    resize['numpy_37x50'] = _resize_errors(
        [(_bilinear_resize_numpy if _mild_ratio(*small.shape[:2], *t) else _area_resize_numpy)(
            small, *t) for t in targets], [plain_resize(small, *t) for t in targets])
    checks['resize'] = resize
    bad = {k: v for k, v in resize.items() if v['max_abs_err'] > 1}
    if bad:
        raise AssertionError('resize routes beyond 1 LSB of the plain route: {}'.format(bad))

    # the host's rate for the slice's decode+resize
    rates = {}
    stores = [('png', png_url)] + ([('jpeg', jpeg_url)] if jpeg_url else [])
    for fmt, url in stores:
        col, fld = _store_cells(url, CHECK_IMAGES)
        budget = os.environ.get('PSTPU_IMG_THREADS')
        os.environ['PSTPU_IMG_THREADS'] = '1'  # one core: no native fan-out
        try:
            one = _decode_rate(fld, col, 1)
        finally:
            if budget is None:
                del os.environ['PSTPU_IMG_THREADS']
            else:
                os.environ['PSTPU_IMG_THREADS'] = budget
        rates[fmt] = {'one_core': one, 'pool': _decode_rate(fld, col, os.cpu_count() or 1)}
    emit({'phase': 'decode_checks', 'probe': probe, 'checks': checks, 'rates': rates,
          'host': _host_cpu()})
    image_routes.reset()


def check_image_batch(expected):
    """A check of a staged batch against ``expected`` (label -> the images
    of the store under that label, decoded and resized by the plain route):
    each staged image is within 1 LSB of one of its label's images."""
    def check(images, labels):
        for image, label in zip(images, labels):
            if not any(_max_err(image, e) <= 1 for e in expected.get(int(label), ())):
                raise AssertionError('a staged image matches no stored row of label {} within '
                                     '1 LSB'.format(label))
    return check


def expected_images(url, written, route):
    """label -> the store's images through the plain route: the images as
    written (PNG) or the stored cells decoded by the decode route (JPEG),
    resized by :func:`plain_resize`."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.native import image_codec

    table = pq.read_table(os.path.join(url[len('file://'):], 'part-00000.parquet'),
                          columns=['noun_id', 'image'])
    labels = [label_of(n) for n in table.column('noun_id').to_pylist()]
    if written:
        images = written
    elif route == 'native':
        images = image_codec.decode_images(table.column('image').to_pylist(),
                                           min_size=(IMAGE_SIZE, IMAGE_SIZE))
    else:
        import cv2
        images = [cv2.cvtColor(cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_COLOR),
                               cv2.COLOR_BGR2RGB) for c in table.column('image').to_pylist()]
    expected = {}
    for label, img in zip(labels, images):
        expected.setdefault(label, []).append(plain_resize(img, IMAGE_SIZE, IMAGE_SIZE))
    return expected


def check_routes(counts, routes):
    """Images went only through the named decode and resize routes."""
    allowed = {'resize_' + routes['resize']}
    allowed |= ({'decode_native'} if routes['decode'] == 'native'
                else {'decode_cv2', 'decode_fallback'})
    unexpected = {k: v for k, v in counts.items() if v and k not in allowed}
    if unexpected:
        raise AssertionError('images on unexpected routes {} (named: {})'.format(
            unexpected, routes))


def new_train_state(torch):
    from petastorm_tpu_torch.models import resnet50
    from petastorm_tpu_torch.models.train import create_train_state

    torch.manual_seed(SEED)
    return create_train_state(resnet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16))


def run_path(torch, name, url, check, reader_kwargs=None, routes=None):
    """One path: a fresh model from the seed, 3 warm-up and 10 measured steps
    through ``pipeline_duty_cycle``. The normalize launches and the image
    route counts cover this path's run alone."""
    from petastorm_tpu_torch.codecs import image_routes
    from petastorm_tpu_torch.models.train import make_train_step
    from petastorm_tpu_torch.ops import normalize_images, random_flip
    from petastorm_tpu_torch.ops.kernels import normalize as nk
    from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle

    state = new_train_state(torch)

    def preprocess(images, generator):
        return normalize_images(random_flip(images, generator), IMAGENET_MEAN, IMAGENET_STD,
                                out_dtype=torch.bfloat16)

    train_step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED)
    losses = []
    first_batch = []

    def step_fn(images, labels):
        if not losses:
            # first warm-up step: the batch on the card is rows of the store
            if images.dtype != torch.uint8 or tuple(images.shape) != (
                    BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) or images.device.type != DEVICE_TYPE:
                raise AssertionError('staged batch: {} {} on {}'.format(
                    images.dtype, tuple(images.shape), images.device))
            check(images.cpu().numpy(), labels.cpu().numpy())
            first_batch.extend([images, labels])
        _, metrics = train_step(state, images, labels)
        losses.append(metrics['loss'])

    kwargs = {'seed': SEED, 'shuffle_row_groups': True,
              'workers_count': max(1, os.cpu_count() or 1), **(reader_kwargs or {})}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    image_routes.reset()
    nk.launches = 0
    t0 = time.perf_counter()
    result = pipeline_duty_cycle(
        url, step_fn, lambda b: (b['image'], b['label']), batch_size=BATCH, steps=STEPS,
        warmup_steps=WARMUP_STEPS, reader_kwargs=kwargs,
        loader_kwargs={'shuffling_queue_capacity': 512, 'seed': SEED})
    wall_s = time.perf_counter() - t0
    launches = {'normalize': nk.launches}
    counts = image_routes.snapshot()
    losses = [float(x) for x in losses]
    emit({'phase': 'path', 'path': name, 'model': 'resnet50', 'dtype': 'bfloat16',
          'num_classes': NUM_CLASSES, 'batch_size': BATCH, 'image_size': IMAGE_SIZE,
          'rows': ROWS, 'warmup_steps': WARMUP_STEPS, 'steps': STEPS,
          'examples_per_sec': result.samples_per_second,
          'input_stall_fraction': result.input_stall_fraction,
          'median_step_ms': result.extra['median_step_ms'],
          'step_ms': result.extra['step_ms'],
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'losses': losses, 'launches': launches, 'image_routes': counts,
          'named_routes': routes, 'cache': result.extra['cache'], 'wall_s': wall_s})
    if len(losses) != WARMUP_STEPS + STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError('{}: losses {}'.format(name, losses))
    # zero-initialised last batch norms make the fresh model's logits small:
    # the first loss is close to log(classes)
    if abs(losses[0] - math.log(NUM_CLASSES)) > 1.0:
        raise AssertionError('{}: first loss {} is far from log({}) = {}'.format(
            name, losses[0], NUM_CLASSES, math.log(NUM_CLASSES)))
    for kernel, count in launches.items():
        if count < WARMUP_STEPS + STEPS:
            raise AssertionError('{}: kernel {} launched {} times in {} steps'.format(
                name, kernel, count, WARMUP_STEPS + STEPS))
    if routes is not None:
        check_routes(counts, routes)
    return launches, state, train_step, first_batch, result


def phase_profile(torch, state, train_step, images, labels, step_ms):
    """Three more train steps on one staged batch under ``torch.profiler``:
    the device's busy time per step by kernel, and its idle share against
    the main path's median step time (taken without the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # the same step on a batch already on the card, with the reader, loader
    # and infeed threads stopped: what the step costs without their host work
    staged_ms = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(state, images, labels)
        end.record()
        torch.cuda.synchronize()
        staged_ms.append(start.elapsed_time(end))
    steps = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            train_step(state, images, labels)
        torch.cuda.synchronize()
    # the device's own activities (kernels, copies, fills), not the host
    # operators that launched them nor ranges annotated on the device's
    # timeline (the optimizer step's)
    activities = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, 'is_user_annotation', False)]
    by_name = {}
    for e in activities:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_us, end = 0.0, None  # union of the activities' intervals
    for e in sorted(activities, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        if end is None or start >= end:
            busy_us += stop - start
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    busy_ms = busy_us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({'phase': 'profile', 'steps': steps, 'device_busy_ms_per_step': busy_ms,
          'median_step_ms': step_ms, 'staged_step_ms': staged_ms,
          'median_staged_step_ms': statistics.median(staged_ms),
          # no device activity in the trace means the profiler saw none
          'device_idle_share': max(0.0, 1 - busy_ms / step_ms) if busy_ms else None,
          'device_activities_per_step': len(activities) / steps,
          'top': [{'name': name[:90], 'ms_per_step': us / 1e3 / steps, 'calls_per_step': n / steps}
                  for name, (us, n) in top]})


def phase_model_check(torch, model, images):
    """The trained full-width model on the card (bf16 body) against a float32
    copy of it on the CPU, in eval mode, on four images of the store."""
    import copy

    from petastorm_tpu_torch.ops import normalize_images

    model.eval()
    with torch.no_grad():
        card = model(normalize_images(images[:4], IMAGENET_MEAN, IMAGENET_STD)).float().cpu()
        reference = copy.deepcopy(model).cpu()
        for module in reference.modules():
            if hasattr(module, 'dtype'):
                module.dtype = torch.float32
        cpu = reference(normalize_images(images[:4].cpu(), IMAGENET_MEAN, IMAGENET_STD,
                                         out_dtype=torch.float32))
    err = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    # bf16 keeps 8 significand bits: each of ~50 layers rounds at 2**-9
    # relative, which leaves logits within a few percent of float32
    tolerance = 0.05 * scale
    emit({'phase': 'model_check', 'max_abs_err': err, 'max_abs_logit': scale,
          'tolerance': tolerance, 'argmax_agree': int((card.argmax(-1) == cpu.argmax(-1)).sum())})
    if not err <= tolerance:
        raise AssertionError('bf16 ResNet-50 on the card is {} from float32 on the CPU'.format(err))


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def main():
    os.makedirs(BUILD_DIR, exist_ok=True)
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(BUILD_DIR, 'triton'))
    import torch

    import petastorm_tpu_torch  # noqa: F401 - fails here when run outside a checkout

    card = phase_device(torch)
    kernels = phase_kernels(torch)
    work_dir = tempfile.mkdtemp(prefix='smoke_', dir=BUILD_DIR)
    try:
        probe = probe_host()
        urls, stores = {}, {}
        for name in ('raw', 'png', 'jpeg'):
            if name == 'jpeg' and probe['routes']['jpeg'] is None:
                continue
            path = os.path.join(work_dir, name)
            urls[name] = 'file://' + path
            t0 = time.perf_counter()
            if name == 'raw':
                build_store(urls[name])
            else:
                stores[name] = build_image_store(urls[name], name, JPEG_DIMS if name == 'jpeg'
                                                 else PNG_DIMS, probe['encoder'])
            emit({'phase': 'store', 'store': name, 'rows': ROWS, 'bytes': _dir_bytes(path),
                  'build_s': time.perf_counter() - t0})
        phase_decode_checks(urls['png'], stores['png'], urls.get('jpeg'), probe)

        launches, state, train_step, (images, labels), raw = run_path(
            torch, 'raw', urls['raw'], check_batch)
        total = dict(launches)
        routes = probe['routes']
        cache_kwargs = {'cache_type': 'local-disk',
                        'cache_location': os.path.join(work_dir, 'disk_cache'),
                        'cache_size_limit': 10 << 30, 'cache_row_size_estimate': 200 << 10}
        image_kwargs = {'transform_spec': image_transform()}
        png_check = check_image_batch(expected_images(urls['png'], stores['png'], None))
        for name in ('png', 'png_cached', 'jpeg'):
            if name == 'jpeg' and routes['jpeg'] is None:
                emit({'phase': 'path', 'path': 'jpeg', 'skipped': True,
                      'why': 'the probe found no JPEG encoder (OpenCV) on this host',
                      'probe_modules': probe['modules'], 'native': probe['native']})
                continue
            kwargs = dict(image_kwargs)
            if name == 'png_cached':
                # one epoch fills the cache, so the run below sees every
                # later epoch: no decode, the transform still runs
                kwargs.update(cache_kwargs)
                from petastorm_tpu_torch import make_reader
                with make_reader(urls['png'], num_epochs=1, **kwargs) as reader:
                    for _ in reader:
                        pass
            fmt = 'jpeg' if name == 'jpeg' else 'png'
            check = png_check if fmt == 'png' else check_image_batch(
                expected_images(urls['jpeg'], None, routes['jpeg']['decode']))
            path_launches, _, _, _, result = run_path(
                torch, name, urls[fmt], check, reader_kwargs=kwargs, routes=routes[fmt])
            if name == 'png_cached':
                cache = result.extra['cache']
                if cache['misses'] or not cache['hits']:
                    raise AssertionError('png_cached read {} row groups past the cache '
                                         '({} hits)'.format(cache['misses'], cache['hits']))
            for kernel, count in path_launches.items():
                total[kernel] += count
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    phase_profile(torch, state, train_step, images, labels, raw.extra['median_step_ms'])
    phase_model_check(torch, state.model, images)
    for entry in kernels:
        entry['launches'] = total[entry['name']]
    emit({'kernels': kernels})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    sys.exit(main())
