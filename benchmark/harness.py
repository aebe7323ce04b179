"""One run of one cell of the benchmark of ``petastorm_tpu_torch``.

Everything that belongs to a cell is found by name: the cell in
``BENCHMARK.json``; its configuration's file; the model kind that
configuration's ``model`` names in ``benchmark/models/<model>.py``
(:data:`KIND_NAMES`) and the plain reference that kind names in
``benchmark/reference/<reference>.py`` (:data:`REFERENCE_NAMES`); its
traffic in ``benchmark/traffic/<traffic>.json``; its limits in
``benchmark/workloads/<cell>.json``; the store kind the
traffic names in ``benchmark/stores/<kind>.py``; each metric's reader in
``benchmark/metrics/<metric>.py``.

A run: set-up (the store, built once per checkout; the model's weights made
on the card from the seed; the reader, loader, infeed and the step), three
steps whose outputs the reference follows, warm-up steps, the measured
window (one of its steps drawn from the seed, with the program's state
copied off the card around it), then the checks against the plain
reference once the program's state is freed.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, '.cache')

#: top-level modules no run may hold once its window has closed
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'petastorm_tpu')

#: steps whose outputs the reference follows
CHECKED_STEPS = 3

#: bump when a store kind writes different bytes for the same parameters
STORE_VERSION = 1

#: what a model kind (``benchmark/models/<model>.py``) gives the harness:
#:
#: - ``FIELDS``: the batch fields the checks compare, in the order the
#:   store's ``expected`` gives them;
#: - ``STEP_MARKER``: a kernel each step launches once, which marks the
#:   step boundaries in a trace;
#: - ``REFERENCE``: the name of its plain reference,
#:   ``benchmark/reference/<REFERENCE>.py`` (:data:`REFERENCE_NAMES`);
#: - ``CONTROL``: the precision the control computes in (``quant=``);
#: - ``FAULTS``: ``{name: () -> context manager}``, the faults of its own
#:   (:mod:`benchmark.faults`);
#: - ``make_weights(config, seed, device)``: ``{leaf: float32 tensor}``;
#: - ``train_state(config, device)``: the port's train state, whose
#:   ``module`` has the leaves as its parameters;
#: - ``train_step(config, draw_seed, graphed)``: the step,
#:   ``(state, *inputs) -> (state, metrics)``;
#: - ``feed(batch)``: the step's inputs from a staged batch;
#: - ``optimizer_state(state, params)``: ``{key: tensor}``, what the
#:   optimizer keeps;
#: - ``gradient(config, before, after)``: ``{leaf: tensor}``, a step's
#:   gradient from the optimizer's state before it (None: the first step)
#:   and after it;
#: - ``data_numbers(staged, expected)``: ``{check: number}``, the staged
#:   fields against the store's (of no batches: every name, at 0);
#: - ``step_flops(config)``: the FLOPs of one step.
KIND_NAMES = ('FIELDS', 'STEP_MARKER', 'REFERENCE', 'CONTROL', 'FAULTS', 'make_weights',
              'train_state', 'train_step', 'feed', 'optimizer_state', 'gradient', 'data_numbers',
              'step_flops')

#: what a plain reference (``benchmark/reference/<name>.py``) gives: it
#: imports nothing of the program, and takes nothing the program made
#:
#: - ``train_steps(params0, batches, config, draw_seed, quant=None)``:
#:   ``{'losses', 'first_grad', 'change', 'grad_max'}`` of the first steps;
#: - ``window_step(params, opt_state, *fields, config, draw_seed, step,
#:   quant=None)``: ``{'loss', 'grad', 'change'}`` of one step from the
#:   program's state.
REFERENCE_NAMES = ('train_steps', 'window_step')


class BenchmarkError(RuntimeError):
    """A run that cannot measure: it prints no result."""


def set_environment():
    """Before the program is imported: every build and kernel cache at a
    fixed path inside the checkout, and no JAX pulled in by a library."""
    os.environ['TRITON_CACHE_DIR'] = os.path.join(CACHE, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(CACHE, 'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def process_start():
    """The wall-clock time this process started (``/proc``), else now."""
    try:
        with open('/proc/self/stat') as f:
            start_ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/stat') as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith('btime'))
        return boot + start_ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


# -- finding a cell's files ------------------------------------------------------

#: the modules :func:`load_file` has loaded, by path
_LOADED = {}


def load_file(path):
    """The module in the file ``path``, loaded once in a process, as an
    import is: a fault that patches a kind's own class patches the class
    the run uses."""
    path = os.path.abspath(path)
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            'benchmark_file_{}'.format(len(_LOADED)), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


class Cell(object):
    """A cell as ``BENCHMARK.json`` and its files describe it."""

    def __init__(self, name, root=ROOT, bench_dir=HERE):
        with open(os.path.join(root, 'BENCHMARK.json')) as f:
            spec = json.load(f)
        entries = [w for w in spec['workloads'] if w['name'] == name]
        if not entries:
            raise BenchmarkError('no cell named {!r} in BENCHMARK.json'.format(name))
        entry = entries[0]
        config_entry = next(c for c in spec['configs'] if c['name'] == entry['config'])
        self.name, self.chips = name, entry['chips']
        with open(os.path.join(root, config_entry['file'])) as f:
            self.config = json.load(f)
        with open(os.path.join(bench_dir, 'traffic', entry['traffic'] + '.json')) as f:
            self.traffic = json.load(f)
        with open(os.path.join(bench_dir, 'workloads', name + '.json')) as f:
            checks = json.load(f)
        self.limits, self.not_compared = checks['limits'], checks.get('not_compared', [])

        def applies(metric):
            return name in metric.get('workloads', [name])

        self.end_to_end = [m['name'] for m in spec['end_to_end'] if applies(m)]
        self.per_layer = [m['name'] for m in spec['per_layer'] if applies(m)]
        self.units = {m['name']: m['unit'] for m in spec['end_to_end'] + spec['per_layer']}
        self.bench_dir = bench_dir
        self.cache = os.path.join(bench_dir, '.cache')

    def _module(self, folder, name):
        return load_file(os.path.join(self.bench_dir, folder, name + '.py'))

    def store_module(self):
        return self._module('stores', self.traffic['store'])

    def _complete(self, folder, name, names):
        module = self._module(folder, name)
        missing = [n for n in names if not hasattr(module, n)]
        if missing:
            raise BenchmarkError('{}/{}.py lacks {}'.format(folder, name, ', '.join(missing)))
        return module

    def model_module(self):
        """The model kind the configuration names (:data:`KIND_NAMES`)."""
        return self._complete('models', self.config['model'], KIND_NAMES)

    def reference_module(self):
        """The plain reference the model kind names (:data:`REFERENCE_NAMES`)."""
        return self._complete('reference', self.model_module().REFERENCE, REFERENCE_NAMES)

    def metric_reader(self, metric):
        return self._module('metrics', metric).read


def derive_seed(seed, purpose, words=1):
    """A seed for one purpose, from the run's ``--seed`` (any whole number)."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), purpose]).generate_state(words)
    value = 0
    for word in state:
        value = (value << 32) | int(word)
    return value


class Seeds(object):
    def __init__(self, seed):
        self.weights = derive_seed(seed, 1, words=2)
        self.reader = derive_seed(seed, 2)
        self.loader = derive_seed(seed, 3)
        self.preprocess = derive_seed(seed, 4)
        self.sample = derive_seed(seed, 5)


def ensure_store(cell):
    """The cell's store, built once per checkout at a fixed path named by
    its kind and parameters."""
    kind, params = cell.traffic['store'], cell.traffic['store_params']
    key = json.dumps([STORE_VERSION, kind, params, cell.config], sort_keys=True)
    path = os.path.join(cell.cache, 'stores', '{}-{}'.format(
        kind, hashlib.sha1(key.encode()).hexdigest()[:12]))
    done = path + '.done'
    if not os.path.exists(done):
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cell.store_module().build(path, cell.config, params)
        with open(done, 'w') as f:
            f.write(key)
    return path


# -- the program under test ----------------------------------------------------

class Program(object):
    """The port's training pipeline for a cell: reader -> ``TorchDataLoader``
    -> ``prefetch_to_device`` -> the model kind's step (graphed on the card)."""

    def __init__(self, cell, store_path, seeds, device, workers, weights, phase):
        import torch

        from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device

        config, self.kind = cell.config, cell.model_module()
        self.state = self.kind.train_state(config, device)
        named = dict(self.state.module.named_parameters())
        if set(named) != set(weights):
            raise BenchmarkError('the model\'s parameters are not the configuration\'s: {}'.format(
                sorted(set(named) ^ set(weights))[:6]))
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(weights[name])
        self.params = named
        phase('model')
        self.step_fn = self.kind.train_step(config, seeds.preprocess, device.type == 'cuda')
        self.reader = cell.store_module().open_reader(
            'file://' + store_path, config, cell.traffic['store_params'], seeds.reader, workers)
        phase('reader')
        self.loader = TorchDataLoader(self.reader, config['batch_size'],
                                      shuffling_queue_capacity=config['shuffling_queue_capacity'],
                                      seed=seeds.loader)
        self.it = prefetch_to_device(self.loader, device, size=config['prefetch_batches'])

    def step(self, batch):
        self.state, metrics = self.step_fn(self.state, *self.kind.feed(batch))
        return metrics

    def optimizer_state(self):
        return self.kind.optimizer_state(self.state, self.params)

    def close(self):
        try:
            self.it.close()
        finally:
            self.loader.stop()
            self.reader.join()


def _layout(tensors):
    return [(n, t.shape, t.numel()) for n, t in tensors.items()]


class WindowStep(object):
    """The step of the window that comes first at ``at_s`` seconds into it
    (drawn from the seed): its batch, its loss, and the program's parameters
    and optimizer state before and after it, copied off the card in the
    stream's order into host memory allocated before the window, so that the
    reference follows this replay from the program's own state."""

    def __init__(self, params, opt_state, at_s, device):
        import torch

        self.at_s = at_s
        # params before, optimizer state before, params after, state after
        self.layouts = [_layout(params), _layout(opt_state)] * 2
        sizes = [sum(k for _, _, k in layout) for layout in self.layouts]
        self.offsets = [sum(sizes[:row]) for row in range(4)]
        self.host = torch.empty(sum(sizes), dtype=torch.float32,
                                pin_memory=device.type == 'cuda')
        self.taken = None

    def _copy(self, row, tensors):
        offset = self.offsets[row]
        for n, shape, k in self.layouts[row]:
            self.host[offset:offset + k].view(shape).copy_(tensors[n].detach(), non_blocking=True)
            offset += k

    def step(self, program, batch, elapsed_s):
        if self.taken is not None or elapsed_s < self.at_s:
            return program.step(batch)
        self._copy(0, program.params)
        self._copy(1, program.optimizer_state())
        index = program.state.step
        metrics = program.step(batch)
        self._copy(2, program.params)
        self._copy(3, program.optimizer_state())
        self.taken = {'batch': batch, 'loss': metrics['loss'], 'index': index}
        return metrics

    def leaves(self, row):
        """``{key: tensor}`` of one of the four copies, on the host."""
        out, offset = {}, self.offsets[row]
        for n, shape, k in self.layouts[row]:
            out[n] = self.host[offset:offset + k].view(shape)
            offset += k
        return out


def nvidia_smi_power_limit():
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader'],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    try:
        return float(out.stdout.split('\n')[0].split()[0])
    except (IndexError, ValueError):
        return None


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


class Context(object):
    """What the metric readers (``benchmark/metrics/<metric>.py``) read."""

    def __init__(self, **values):
        self.__dict__.update(values)

    def delta(self, key):
        return float(self.diag1.get(key, 0) or 0) - float(self.diag0.get(key, 0) or 0)


def run_cell(cell, seed, seconds, trace, device, clock, t_start, control=False):
    """One run; returns the result's dict (``correct`` and the rest) and the
    rows of the checks, ``[(name, value, limit)]``."""
    import torch

    from benchmark import checks, duty, flops

    config, seeds, kind = cell.config, Seeds(seed), cell.model_module()
    workers = cell.traffic.get('workers') or len(os.sched_getaffinity(0))
    phases = [('start', time.time() - t_start)]

    def phase(name):
        phases.append((name, time.time() - t_start))

    store_path = ensure_store(cell)
    phase('store')
    cuda = device.type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    weights = kind.make_weights(config, seeds.weights, device)
    phase('weights')
    program = Program(cell, store_path, seeds, device, workers, weights, phase)
    del weights
    phase('loader')
    p0 = {n: p.detach().to('cpu', copy=True) for n, p in program.params.items()}
    row_ids, checked, losses, first_state = [], [], [], None
    for k in range(CHECKED_STEPS):
        batch = next(program.it)
        losses.append(program.step(batch)['loss'])
        checked.append(batch)
        row_ids.append(batch['row_id'])
        clock.sync()
        phase('step{}'.format(k + 1))
        if k == 0:
            first_state = {n: t.to('cpu', copy=True)
                           for n, t in program.optimizer_state().items()}
    change = {n: p.detach().cpu() - p0[n] for n, p in program.params.items()}
    del p0
    for _ in range(cell.traffic['warmup_steps']):
        batch = next(program.it)
        program.step(batch)
        row_ids.append(batch['row_id'])
    rng = np.random.default_rng(seeds.sample)
    window_step = WindowStep(program.params, program.optimizer_state(),
                             seconds * rng.uniform(0.2, 0.8), device)
    clock.sync()
    phase('warmup_steps')
    print('setup: ' + ', '.join('{} {:.2f} s'.format(n, t) for n, t in phases), file=sys.stderr)

    profiler = None
    trace_path = os.path.join(cell.cache, 'trace', cell.name + '.json')
    window_start = time.perf_counter()
    deadline = window_start + seconds

    def step(batch):
        return window_step.step(program, batch, time.perf_counter() - window_start)

    def on_step(k, batch):
        nonlocal profiler
        row_ids.append(batch['row_id'])
        if trace and profiler is None and deadline - time.perf_counter() <= \
                cell.traffic['trace_seconds']:
            profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
            profiler.start()

    setup_s = time.time() - t_start
    diag0 = dict(program.loader.diagnostics)
    window = duty.run_window(program.it, step, seconds, clock, torch, on_step=on_step)
    diag1 = dict(program.loader.diagnostics)
    reduced = None
    if profiler is not None:
        profiler.stop()
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        profiler.export_chrome_trace(trace_path)
        del profiler
        from benchmark.trace import reduce_trace
        reduced = reduce_trace(trace_path, kind.STEP_MARKER)
        os.remove(trace_path)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    program_losses = [float(x) for x in losses]
    taken = window_step.taken
    if taken is not None:
        checked.append(taken['batch'])
        taken = dict(taken, loss=float(taken['loss']), batch=None)
    staged = [tuple(b[field].cpu().numpy() for field in kind.FIELDS) for b in checked]
    staged_ids = [b['row_id'].cpu().numpy() for b in checked]
    all_ids = torch.cat(row_ids).cpu().numpy()
    program.close()
    del program, checked, batch, row_ids
    window_step.taken = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    loaded = forbidden_modules()
    if loaded:
        raise BenchmarkError('the run loaded {}'.format(', '.join(loaded)))

    # -- the reference, with the program's state freed --------------------------
    store = cell.store_module()
    expected, extra = [], {}
    for ids in staged_ids:
        # an id outside the store (counted by unknown_rows) is compared
        # against a row of the store, which it cannot match; the store gives
        # the kind's fields, then numbers of its own
        *fields, more = store.expected(store_path, config, cell.traffic['store_params'],
                                       [int(i) % config['rows'] for i in ids])
        expected.append(tuple(fields))
        for name, value in more.items():
            extra[name] = extra.get(name, 0) + value
    numbers = kind.data_numbers(staged, expected)
    numbers.update(checks.row_numbers(all_ids, config['rows']))
    numbers.update(extra)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        reference = cell.reference_module()
        params0 = kind.make_weights(config, seeds.weights, device)
        batches = [tuple(torch.from_numpy(values).to(device) for values in fields)
                   for fields in expected]
        ref = reference.train_steps(params0, batches[:CHECKED_STEPS], config, seeds.preprocess)
        prog = {'losses': program_losses, 'first_grad': kind.gradient(config, None, first_state),
                'change': change}
        numbers.update(checks.model_numbers(prog, ref))
        window_prog = window_ref = None
        if taken is not None:
            p0, s0, p1, s1 = (window_step.leaves(row) for row in range(4))
            window_prog = {'loss': taken['loss'], 'grad': kind.gradient(config, s0, s1),
                           'change': {n: p1[n] - p0[n] for n in p1}}
            window_args = ({n: t.to(device) for n, t in p0.items()},
                           {n: t.to(device) for n, t in s0.items()}) + batches[CHECKED_STEPS] + (
                config, seeds.preprocess, taken['index'])
            window_ref = reference.window_step(*window_args)
        numbers.update(checks.window_numbers(window_prog, window_ref))
        control_numbers = None
        if control:
            low = reference.train_steps(params0, batches[:CHECKED_STEPS], config,
                                        seeds.preprocess, quant=kind.CONTROL)
            control_numbers = checks.model_numbers(low, ref)
            if window_ref is not None:
                control_numbers.update(checks.window_numbers(
                    reference.window_step(*window_args, quant=kind.CONTROL), window_ref))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    correct, rows = checks.judge(numbers, cell.limits, cell.not_compared)

    names = cell.per_layer if trace else cell.end_to_end
    ctx = Context(window=window, config=config, kind=kind, diag0=diag0, diag1=diag1, trace=reduced,
                  setup_s=setup_s, memory_peak_bytes=memory_peak,
                  peak=flops.peak(torch.cuda.get_device_name(device)) if cuda else None)
    metrics = {}
    for name in names:
        value = cell.metric_reader(name)(ctx)
        if value is not None:
            metrics[name] = {'value': float(value), 'unit': cell.units[name]}
    result = {'correct': correct, 'attempted': window['steps'], 'failed': 0, 'metrics': metrics,
              'device': describe_device(torch, device, cell.chips, memory_peak, reduced)}
    if reduced is not None:
        result['breakdown'] = {'device_ops': reduced['device_ops'],
                               'idle_gaps': reduced['idle_gaps']}
    result['losses'] = {'program': program_losses, 'reference': ref['losses']}
    if control_numbers is not None:
        result['control'] = control_numbers
    # the numbers compared, beside their limits, come last
    result['checks'] = {name: {'value': value, 'limit': limit} for name, value, limit in rows}
    return result, rows


def describe_device(torch, device, count, memory_peak, reduced):
    if device.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': count, 'memory_peak_bytes': 0}
    out = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': count,
           'memory_peak_bytes': int(memory_peak), 'power_limit_w': nvidia_smi_power_limit()}
    if reduced is not None:
        out['busy_s'], out['window_s'] = reduced['busy_s'], reduced['window_s']
    return out


def require_chips(torch, chips):
    """The card this run measures on; a run without enough cards fails."""
    if not torch.cuda.is_available():
        raise BenchmarkError('CUDA is not available: the benchmark measures on the card only')
    if torch.cuda.device_count() < chips:
        raise BenchmarkError('the cell needs {} cards, {} are visible'.format(
            chips, torch.cuda.device_count()))
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)  # the allocator's peak can be reset from here on
    return device


def emit(result, rows):
    """The checks as the last lines of standard error, the result as the last
    line of standard output."""
    for name, value, limit in rows:
        print('check {} = {!r} (limit {!r})'.format(name, value, limit), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
