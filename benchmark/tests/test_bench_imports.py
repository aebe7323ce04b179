"""No run may hold JAX or the JAX package; the reference imports nothing of
the program."""

import ast
import os
import subprocess
import sys
import types

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split('.')[0])
    return names


def _sources(top):
    for dirpath, _, files in os.walk(top):
        if '.cache' in dirpath:
            continue
        for name in files:
            if name.endswith('.py'):
                yield os.path.join(dirpath, name)


def test_the_check_fails_on_jax_and_passes_the_port(monkeypatch):
    port = types.ModuleType('petastorm_tpu_torch')
    monkeypatch.setitem(sys.modules, 'petastorm_tpu_torch', port)
    for name in harness.FORBIDDEN_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'jax', types.ModuleType('jax'))
    codecs = types.ModuleType('petastorm_tpu.codecs')
    monkeypatch.setitem(sys.modules, 'petastorm_tpu.codecs', codecs)
    assert harness.forbidden_modules() == ['jax', 'petastorm_tpu']


def test_a_module_loaded_after_the_window_stops_the_result(monkeypatch, capsys):
    """The check before the result line catches what the checks or a
    metric's reader pulled in after the window closed."""
    from benchmark import run

    def late_import(*args, **kwargs):
        sys.modules['jax'] = types.ModuleType('jax')
        return {'correct': True}, []

    for name in harness.FORBIDDEN_MODULES:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setattr(harness, 'require_chips', lambda torch, chips: torch.device('cpu'))
    monkeypatch.setattr(harness, 'run_cell', late_import)
    try:
        assert run.main(['--workload', 'rn50_petastorm.raw', '--seed', '1', '--seconds', '1',
                         '--trace', '0']) != 0
    finally:
        sys.modules.pop('jax', None)
    out, err = capsys.readouterr()
    assert out.strip() == ''
    assert 'the run loaded jax' in err


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        assert not _imported(path) & set(harness.FORBIDDEN_MODULES), path


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield '.' * node.level + (node.module or '')


def test_the_reference_imports_nothing_of_the_program():
    """Every plain reference (``reference/``, and the test kind's under
    ``tests/``) imports nothing of the program, and of the benchmark only
    other references."""
    references = [os.path.join(dirpath, 'reference') for dirpath, dirs, _ in os.walk(BENCH)
                  if 'reference' in dirs]
    assert os.path.join(BENCH, 'reference') in references
    paths = [path for top in references for path in _sources(top)]
    assert len(paths) >= 4, paths
    for path in paths:
        for module in _imported_modules(path):
            top = module.split('.')[0]
            assert top != 'petastorm_tpu_torch', (path, module)
            if top == 'benchmark' or module.startswith('.'):
                assert module.startswith('benchmark.reference.'), (path, module)


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, os.path.join(BENCH, 'run.py'), '--workload',
                           'rn50_petastorm.raw', '--seed', str(2 ** 31 + 5), '--seconds', '1',
                           '--trace', '0'], capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=''), cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'CUDA is not available' in proc.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copytree(BENCH, str(tmp_path / 'benchmark'),
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), str(tmp_path))
    proc = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', 'rn50_petastorm.raw',
                           '--seed', '1', '--seconds', '1', '--trace', '0'],
                          capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=''))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
