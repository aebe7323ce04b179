"""chip_smoke.py: the quickest proof that petastorm_tpu_torch runs on an NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card, its power limit, and the TF32 settings used;
2. kernel checks: every hand-written kernel of the main path against its plain
   PyTorch version on the card (shapes, types and tolerances below), and the
   times of both (CUDA events, median of 25 runs);
3. main path: a raw uint8 ImageNet-shaped Parquet store written by the port's
   ``materialize_dataset`` -> ``make_reader(output='columnar')`` (thread pool)
   -> ``TorchDataLoader`` (batch 64, shuffle 512, seed 7) ->
   ``prefetch_to_device(size=2)`` -> a full-width ResNet-50 bf16 train step
   (1000 classes, SGD 0.1 momentum 0.9) with ``random_flip`` and
   ``normalize_images`` inside it: 3 warm-up and 10 measured steps through
   ``pipeline_duty_cycle``. The kernels' launch counts are set to 0 just
   before this phase and read just after it; a kernel of the path that was
   not launched fails the run. The first staged batch is checked against the
   store's rows, the losses for being finite and starting near log(1000);
4. profile: three more steps under ``torch.profiler``, the device's busy
   time per step by kernel and its idle share;
5. model check: the trained model on the card (bf16) against a float32 copy
   of it on the CPU, on four images of the store;
6. a ``kernels`` line (per kernel: route, source, the TPU kernel it replaces,
   launches on the main path, max error, its time, the plain version's time,
   the least time the card could take and what bounds it), the card's name
   and power limit as ``nvidia-smi`` gives them, and last
   ``{"ok": true, "device": {...}}``.

No failure is caught: any exception ends the run with a non-zero exit code and
no result line. Without CUDA the run fails at once. The Triton cache and the
temporary store live under ``.torch_build/`` in the checkout.
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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(ROOT, '.torch_build')

IMAGE_SIZE = 160
NUM_CLASSES = 1000
BATCH = 64
ROWS = 1024
ROWS_PER_ROW_GROUP = 64
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


def _image(index):
    """The store's image ``index``: smooth gradients and mild noise, made
    from a seed, so a batch can be checked against the rows it came from."""
    rng = np.random.default_rng([SEED, index])
    yy = np.linspace(0, 4 * np.pi, IMAGE_SIZE)[:, None, None]
    xx = np.linspace(0, 4 * np.pi, IMAGE_SIZE)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, 3)[None, None, :]
    base = np.sin(xx + phase) * 70 + np.cos(yy + phase * 0.5) * 60 + 128
    return np.clip(base + rng.normal(0, 6, (IMAGE_SIZE, IMAGE_SIZE, 3)), 0, 255).astype(np.uint8)


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


def phase_main_path(torch, url):
    from petastorm_tpu_torch.models import resnet50
    from petastorm_tpu_torch.models.train import create_train_state, make_train_step
    from petastorm_tpu_torch.ops import normalize_images, random_flip
    from petastorm_tpu_torch.ops.kernels import normalize as nk
    from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle

    torch.manual_seed(SEED)
    state = create_train_state(resnet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16))

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
                    BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) or not images.is_cuda:
                raise AssertionError('staged batch: {} {} on {}'.format(
                    images.dtype, tuple(images.shape), images.device))
            check_batch(images.cpu().numpy(), labels.cpu().numpy())
            first_batch.extend([images, labels])
        _, metrics = train_step(state, images, labels)
        losses.append(metrics['loss'])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nk.launches = 0
    t0 = time.perf_counter()
    result = pipeline_duty_cycle(
        url, step_fn, lambda b: (b['image'], b['label']), batch_size=BATCH, steps=STEPS,
        warmup_steps=WARMUP_STEPS,
        reader_kwargs={'seed': SEED, 'shuffle_row_groups': True,
                       'workers_count': max(1, os.cpu_count() or 1)},
        loader_kwargs={'shuffling_queue_capacity': 512, 'seed': SEED})
    wall_s = time.perf_counter() - t0
    launches = {'normalize': nk.launches}
    losses = [float(x) for x in losses]
    summary = {'phase': 'main_path', 'model': 'resnet50', 'dtype': 'bfloat16',
               'num_classes': NUM_CLASSES, 'batch_size': BATCH, 'image_size': IMAGE_SIZE,
               'rows': ROWS, 'warmup_steps': WARMUP_STEPS, 'steps': STEPS,
               'examples_per_sec': result.samples_per_second,
               'input_stall_fraction': result.input_stall_fraction,
               'median_step_ms': result.extra['median_step_ms'],
               'step_ms': result.extra['step_ms'],
               'peak_memory_bytes': torch.cuda.max_memory_allocated(),
               'losses': losses, 'launches': launches, 'wall_s': wall_s}
    emit(summary)
    if len(losses) != WARMUP_STEPS + STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError('losses: {}'.format(losses))
    # zero-initialised last batch norms make the fresh model's logits small:
    # the first loss is close to log(classes)
    if abs(losses[0] - math.log(NUM_CLASSES)) > 1.0:
        raise AssertionError('first loss {} is far from log({}) = {}'.format(
            losses[0], NUM_CLASSES, math.log(NUM_CLASSES)))
    for name, count in launches.items():
        if count < WARMUP_STEPS + STEPS:
            raise AssertionError('kernel {} launched {} times in {} steps'.format(
                name, count, WARMUP_STEPS + STEPS))
    return launches, state, train_step, first_batch, result.extra['median_step_ms']


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


def main():
    os.makedirs(BUILD_DIR, exist_ok=True)
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(BUILD_DIR, 'triton'))
    import torch

    import petastorm_tpu_torch  # noqa: F401 - fails here when run outside a checkout

    card = phase_device(torch)
    kernels = phase_kernels(torch)
    store_dir = tempfile.mkdtemp(prefix='smoke_store_', dir=BUILD_DIR)
    try:
        t0 = time.perf_counter()
        build_store('file://' + store_dir)
        emit({'phase': 'store', 'rows': ROWS, 'bytes': sum(
            os.path.getsize(os.path.join(store_dir, f)) for f in os.listdir(store_dir)),
            'build_s': time.perf_counter() - t0})
        launches, state, train_step, (images, labels), step_ms = phase_main_path(
            torch, 'file://' + store_dir)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    phase_profile(torch, state, train_step, images, labels, step_ms)
    phase_model_check(torch, state.model, images)
    for entry in kernels:
        entry['launches'] = launches[entry['name']]
    emit({'kernels': kernels})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    sys.exit(main())
