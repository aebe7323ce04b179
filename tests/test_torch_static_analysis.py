"""The port's static invariant linter (``petastorm_tpu_torch.analysis``),
held against the JAX package's (``petastorm_tpu.analysis``) on the same
inputs.

* **fixture parity** — for every JAX rule code but PT400, both linters give
  the same findings on ``tests/lint_fixtures/<code>/{bad,clean}``.
* **snippet parity** — the framework's edges (noqa in a string, a bare
  noqa, the ``BLE001`` alias, baseline multiplicity and line moves, a syntax
  error) behave the same in both.
* **the port's tree** — no open finding; outside ``torch/`` (which the
  JAX scopes name ``jax/``) the same findings as the JAX linter's, every
  code but PT400; seeded faults in the real sources are caught, in
  ``torch/`` by the port's linter alone.
* **the CLI** — exit codes, ``--format json`` and SARIF results equal the
  JAX CLI's; ``--select``/``--ignore``, baselines, ``--rules``, ``--cache``
  and ``--changed``.
* **PT400** — CUDA-graph capture purity, the port's recast of JAX purity.
* **the meta-gate** — every port rule code has a fixture pair under
  ``tests/torch_lint_fixtures/`` that it fires on and stays silent on.

The whole-tree passes run once for the module (``port_tree``)."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from petastorm_tpu import analysis as jax_analysis
from petastorm_tpu.analysis import cache as jax_cache
from petastorm_tpu.analysis import cli as jax_cli
from petastorm_tpu.analysis import core as jax_core
from petastorm_tpu.analysis.jax_purity import JaxPurityChecker
from petastorm_tpu_torch import analysis
from petastorm_tpu_torch.analysis import cache, cli, core, sarif
from petastorm_tpu_torch.analysis.capture_purity import (CapturePurityChecker,
                                                         _captured_regions)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, 'petastorm_tpu_torch')
JAX_FIXTURES = os.path.join(REPO, 'tests', 'lint_fixtures')
PORT_FIXTURES = os.path.join(REPO, 'tests', 'torch_lint_fixtures')
PORT_BASELINE = os.path.join(PORT_DIR, 'analysis', 'analysis_baseline.json')

#: the rule codes both linters implement alike (PT400 is recast)
SHARED_CODES = [c for c in jax_analysis.ALL_RULE_CODES if c != 'PT400']

PACKAGES = {'jax': (jax_analysis, jax_core, jax_cli), 'torch': (analysis, core, cli)}


def _same(f):
    """A finding as both linters should report it: the port's messages name
    the port's package where the JAX ones name the JAX package."""
    return (f.path, f.line, f.code, f.status,
            f.message.replace('petastorm_tpu_torch', 'petastorm_tpu'), f.snippet)


def _both(paths, **kwargs):
    ours = analysis.run_analysis(paths, keep_suppressed=True, **kwargs)
    theirs = jax_analysis.run_analysis(paths, keep_suppressed=True, **kwargs)
    return [_same(f) for f in ours], [_same(f) for f in theirs]


# -- the rule set ----------------------------------------------------------------------

def test_rule_set_is_the_jax_one_with_pt400_recast():
    assert analysis.ALL_RULE_CODES == jax_analysis.ALL_RULE_CODES
    ours = [c.__name__ for c in analysis.ALL_CHECKERS]
    theirs = [c.__name__ for c in jax_analysis.ALL_CHECKERS]
    assert [n for n in ours if n != 'CapturePurityChecker'] == \
        [n for n in theirs if n != 'JaxPurityChecker']
    assert ours.index('CapturePurityChecker') == theirs.index('JaxPurityChecker')


@pytest.mark.parametrize('index', range(len(jax_analysis.ALL_CHECKERS)),
                         ids=[c.code for c in jax_analysis.ALL_CHECKERS])
def test_checker_matches_its_jax_twin(index):
    """Code, ids, level and scope of each checker are the JAX one's, with the
    port's ``torch/`` where the JAX scopes name ``jax/``."""
    ours, theirs = analysis.ALL_CHECKERS[index], jax_analysis.ALL_CHECKERS[index]
    assert ours.code == theirs.code and ours.rule_codes() == theirs.rule_codes()
    assert ours.program_level == theirs.program_level
    assert ours.scope == tuple(p.replace('*jax/', '*/torch/') for p in theirs.scope)
    if ours is not CapturePurityChecker:
        assert (ours.name, ours.description) == (theirs.name, theirs.description)


def test_torch_scope_names_the_subpackage_only():
    """``*/torch/*.py`` matches the port's ``torch/`` package whether or not
    the scanned root includes the package directory, and never the whole
    package through its name's ``_torch`` suffix."""
    checker = analysis.LockDisciplineChecker()
    for relpath in ('torch/loader.py', 'petastorm_tpu_torch/torch/infeed.py'):
        assert checker.matches_path(relpath), relpath
    for relpath in ('petastorm_tpu_torch/predicates.py', 'torch_utils.py',
                    'petastorm_tpu_torch/etl/legacy.py'):
        assert not checker.matches_path(relpath), relpath


# -- fixture parity --------------------------------------------------------------------

@pytest.mark.parametrize('code', SHARED_CODES)
def test_rule_matches_jax_on_its_fixtures(code):
    for side in ('bad', 'clean'):
        ours, theirs = _both([os.path.join(JAX_FIXTURES, code, side)])
        assert ours == theirs, side
        fired = {f[2] for f in ours if f[3] == 'open'}
        assert (code in fired) == (side == 'bad'), (side, sorted(fired))


# -- snippet parity --------------------------------------------------------------------

_EQ_ONLY = '''
    class C(object):
        def __eq__(self, other):{comment}
            return {value}
'''


def _snippet(package, relpath, text, checker_name, baseline=None):
    pkg, pkg_core, _ = PACKAGES[package]
    src = pkg_core.SourceFile('<snippet>', relpath, textwrap.dedent(text))
    checker = getattr(pkg, checker_name)()
    return [(f.path, f.line, f.code, f.status)
            for f in pkg_core.run_checkers([checker], [src], baseline=baseline,
                                           keep_suppressed=True)]


@pytest.mark.parametrize('case,relpath,text,checker,expected', [
    ('noqa_in_string', 'x.py', _EQ_ONLY.format(comment='', value='"# noqa: PT600"'),
     'HashabilityChecker', [('x.py', 3, 'PT600', 'open')]),
    ('bare_noqa', 'x.py', _EQ_ONLY.format(comment='  # noqa', value='True'),
     'HashabilityChecker', [('x.py', 3, 'PT600', 'noqa')]),
    ('other_code', 'x.py', _EQ_ONLY.format(comment='  # noqa: PT500', value='True'),
     'HashabilityChecker', [('x.py', 3, 'PT600', 'open')]),
    ('ble001_alias', 'workers/pump.py', '''
        def pump(q):
            try:
                q.get()
            except Exception:  # noqa: BLE001 - teardown race, nothing to forward
                pass
     ''', 'ExceptionHygieneChecker', [('workers/pump.py', 5, 'PT300', 'noqa')]),
    ('swallowed', 'workers/pump.py', '''
        def pump(q):
            try:
                q.get()
            except Exception:
                pass
     ''', 'ExceptionHygieneChecker', [('workers/pump.py', 5, 'PT300', 'open')]),
    ('syntax_error', 'x.py', 'def broken(:\n', 'HashabilityChecker',
     [('x.py', 1, 'PT000', 'open')]),
], ids=lambda v: v if isinstance(v, str) and ' ' not in v and '\n' not in v else None)
def test_snippet_matches_jax(case, relpath, text, checker, expected):
    assert _snippet('torch', relpath, text, checker) == \
        _snippet('jax', relpath, text, checker) == expected


_TWO_ALIKE = '''
    class A(object):
        def __eq__(self, other):
            return True

    class B(object):
        def __eq__(self, other):
            return True
'''


@pytest.mark.parametrize('package', ['jax', 'torch'])
def test_baseline_absorbs_with_multiplicity(package, tmp_path):
    pkg, pkg_core, _ = PACKAGES[package]
    src = pkg_core.SourceFile('<snippet>', 'x.py', textwrap.dedent(_TWO_ALIKE))
    findings = pkg_core.run_checkers([pkg.HashabilityChecker()], [src])
    assert len(findings) == 2
    path = str(tmp_path / 'baseline.json')
    pkg_core.write_baseline(path, findings)
    baseline = pkg_core.load_baseline(path)
    assert baseline.absorb(findings) == []
    # a third finding with the same text is not absorbed
    assert len(baseline.absorb(findings + [findings[0]])) == 1
    with open(path) as f:
        written = json.load(f)
    assert written == {'version': 1, 'entries': [
        {'code': 'PT600', 'path': 'x.py', 'line_text': 'def __eq__(self, other):',
         'count': 2}]}


def test_baseline_survives_line_moves(tmp_path):
    moved = 'import os\n\nUNRELATED = os.sep\n' + textwrap.dedent(_TWO_ALIKE)
    for package in ('jax', 'torch'):
        path = str(tmp_path / (package + '.json'))
        pkg, pkg_core, _ = PACKAGES[package]
        v1 = pkg_core.SourceFile('<v1>', 'x.py', textwrap.dedent(_TWO_ALIKE))
        pkg_core.write_baseline(path, pkg_core.run_checkers([pkg.HashabilityChecker()], [v1]))
        assert _snippet(package, 'x.py', moved, 'HashabilityChecker',
                        pkg_core.load_baseline(path)) == [
            ('x.py', 6, 'PT600', 'baselined'), ('x.py', 10, 'PT600', 'baselined')]
    with open(str(tmp_path / 'jax.json')) as a, open(str(tmp_path / 'torch.json')) as b:
        assert a.read() == b.read()
    assert core.load_baseline(str(tmp_path / 'missing.json')).absorb([]) == []


# -- the port's tree -------------------------------------------------------------------

@pytest.fixture(scope='module')
def port_tree():
    """Both linters over the port's tree, suppressed findings kept."""
    ours = analysis.run_analysis([PORT_DIR], baseline=core.load_baseline(PORT_BASELINE),
                                 keep_suppressed=True)
    theirs = jax_analysis.run_analysis([PORT_DIR], keep_suppressed=True)
    return ours, theirs


def test_port_tree_has_no_open_finding(port_tree):
    ours, _ = port_tree
    assert [f.format() for f in ours if f.status == 'open'] == []
    with open(PORT_BASELINE) as f:
        assert json.load(f) == {'entries': [], 'version': 1}


def test_port_tree_matches_jax_outside_torch(port_tree):
    ours, theirs = port_tree

    def outside(findings):
        return [_same(f) for f in findings
                if not f.path.startswith('torch/') and f.code != 'PT400']
    assert outside(ours) == outside(theirs)
    # the twin sites suppress what the JAX tree suppresses
    assert any(f.status == 'noqa' for f in ours)


def test_port_tree_torch_findings_are_suppressed_with_reasons(port_tree):
    """What the port's scopes add: ``torch/`` (the JAX scopes' ``jax/``).
    Each finding there is suppressed at its line with a reason."""
    ours, theirs = port_tree
    assert not [f for f in theirs if f.path.startswith('torch/')]
    added = [f for f in ours if f.path.startswith('torch/')]
    for f in added:
        line = f.snippet.split('# noqa: ', 1)
        assert f.status == 'noqa' and len(line) == 2, f.format()
        assert line[1].split(' - ', 1)[1].strip(), f.format()
    assert [(f.path, f.code) for f in added] == [('torch/loader.py', 'PT300')]


_SEEDED_ABBA = '''

class _SeededA(object):
    def __init__(self):
        self._lock_a = threading.Lock()

    def forward(self, other):
        with self._lock_a:
            other.backward_inner()

    def forward_inner(self):
        with self._lock_a:
            pass


class _SeededB(object):
    def __init__(self):
        self._lock_b = threading.Lock()

    def backward(self, other):
        with self._lock_b:
            other.forward_inner()

    def backward_inner(self):
        with self._lock_b:
            pass
'''

#: (rule, the port's real file, fixed fragment, broken fragment, whether the
#: JAX linter sees it too); None appends the broken fragment
_SEEDED = [
    ('PT900', 'native/rowgroup_reader.cpp', 'uint64_t chunk_len;\n  uint8_t* out;',
     'uint8_t* out;\n  uint64_t chunk_len;', True),
    ('PT900', 'native/rowgroup_reader.cpp', 'int32_t itemsize;', 'int64_t itemsize;', True),
    ('PT900', 'native/rowgroup_reader.cpp', 'uint64_t aux1;',
     'uint64_t aux1;\n  uint64_t aux2;', True),
    ('PT900', 'native/rowgroup_reader.cpp', 'int pstpu_abi_version() { return 4; }',
     'int pstpu_abi_version() { return 5; }', True),
    ('PT901', 'native/shm_ring.cpp', 'uint64_t pstpu_ring_capacity(void* h) {',
     'int pstpu_ring_capacity(void* h) {', True),
    ('PT902', 'native/shm_ring.cpp',
     'int pstpu_ring_write(void* h, const void* data, uint64_t len) {',
     'int pstpu_ring_write(void* h, const void* data) {', True),
    ('PT903', 'native/rowgroup_reader.cpp',
     'if (uint64_t(pg.num_values) > vlen / w) return kColDict;',
     'if (uint64_t(pg.num_values) * w > vlen) return kColDict;', True),
    ('PT903', 'native/rowgroup_reader.cpp', 'if (dict_n > vlen / w) return kColDict;',
     'if (dict_n * w > vlen) return kColDict;', True),
    ('PT903', 'native/rowgroup_reader.cpp', 'if (nv > vlen / w) return kColBounds;',
     'if (nv * w > vlen) return kColBounds;', True),
    ('PT904', 'native/rowgroup_reader.cpp',
     'if (prefix > c->aux_cap || c->aux_buf == nullptr) return kColNonUniform;\n    ', '',
     True),
    ('PT1300', 'workers/ventilator.py', None, _SEEDED_ABBA, True),
    ('PT1301', 'elastic/coordinator.py',
     'with self._lock:\n'
     '            # consumer threads retire stale epochs (del) under the lock; an\n'
     '            # unlocked get here races the dict resize. The state dict itself\n'
     '            # stays valid once fetched — per-epoch state is only ever dropped,\n'
     '            # never rebound.\n'
     '            state = self._epoch_state.get(epoch)',
     'state = self._epoch_state.get(epoch)', True),
    ('PT1302', 'workers/thread_pool.py', 'return list(self._quarantined)',
     'return self._quarantined', True),
    ('PT1303', 'workers/ventilator.py', 'self._cv.wait(timeout=0.1)', 'self._cv.wait()', True),
    # the loader and infeed, which only the port's scopes reach
    ('PT1300', 'torch/loader.py', None, _SEEDED_ABBA, False),
    ('PT1303', 'torch/loader.py',
     '        with self._state_lock:\n            self._shuffle_capacity = capacity\n',
     '        with self._state_lock:\n            time.sleep(0.01)\n'
     '            self._shuffle_capacity = capacity\n', False),
    ('PT300', 'torch/infeed.py',
     'except BaseException as exc:  # noqa: BLE001 - re-raised on the consumer thread\n'
     '            put(_Final(exc))',
     'except Exception:\n            pass', False),
    ('PT701', 'torch/infeed.py',
     'except BaseException as exc:  # noqa: BLE001 - re-raised on the consumer thread\n'
     '            put(_Final(exc))',
     'except BaseException:\n            return', False),
]


def _rule_run(package, rule, root):
    """The findings of ``rule`` by the checker of ``package`` that owns it."""
    checker = next(cls for cls in package.ALL_CHECKERS if rule in cls.rule_codes())
    return [f for f in package.run_checkers([checker()], package.collect_sources([str(root)]))
            if f.code == rule]


@pytest.mark.parametrize('rule,relpath,fixed,broken,jax_sees', _SEEDED,
                         ids=['{}-{}'.format(m[0], i) for i, m in enumerate(_SEEDED)])
def test_seeded_fault_in_a_real_port_source_is_caught(tmp_path, rule, relpath, fixed, broken,
                                                      jax_sees):
    """A copy of the port's directory holding the file (the PT9xx rules read
    the C++ sources beside their ctypes mirrors) with one fault seeded."""
    subdir = os.path.dirname(relpath)
    root = tmp_path / 'petastorm_tpu_torch'
    shutil.copytree(os.path.join(PORT_DIR, subdir), str(root / subdir),
                    ignore=shutil.ignore_patterns('__pycache__', '*.so*', '*.lock'))
    target = root / relpath
    text = target.read_text()
    if fixed is None:
        text += broken
    else:
        assert fixed in text, 'the seeded anchor left {}'.format(relpath)
        text = text.replace(fixed, broken)
    assert rule not in {f.code for f in _rule_run(analysis, rule, root)}
    target.write_text(text)
    ours = _rule_run(analysis, rule, root)
    theirs = _rule_run(jax_analysis, rule, root)
    assert ours, 'the seeded {} in {} was not caught'.format(rule, relpath)
    if jax_sees:
        assert [_same(f) for f in ours] == [_same(f) for f in theirs]
    else:
        assert theirs == []


# -- the CLI ---------------------------------------------------------------------------

def _cli(package, argv, capsys):
    rc = PACKAGES[package][2].main(argv)
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _normalized_json(out):
    records = [json.loads(line) for line in out.splitlines()]
    for r in records:
        r['message'] = r['message'].replace('petastorm_tpu_torch', 'petastorm_tpu')
    return records


def _sarif_results(out):
    doc = json.loads(out)
    for result in doc['runs'][0]['results']:
        result['message']['text'] = result['message']['text'].replace(
            'petastorm_tpu_torch', 'petastorm_tpu')
    return doc


@pytest.mark.parametrize('code', SHARED_CODES)
def test_cli_matches_jax_on_the_fixtures(code, capsys):
    for side in ('bad', 'clean'):
        target = os.path.join(JAX_FIXTURES, code, side)
        text = [_cli(p, [target], capsys) for p in ('torch', 'jax')]
        assert text[0][0] == text[1][0]
        assert text[0][0] == 1 or side == 'clean'
        assert text[0][1].replace('petastorm_tpu_torch', 'petastorm_tpu') == text[1][1]
        lines = [_cli(p, [target, '--format', 'json'], capsys) for p in ('torch', 'jax')]
        assert lines[0][0] == lines[1][0] == text[0][0]
        assert _normalized_json(lines[0][1]) == _normalized_json(lines[1][1])
        docs = [_cli(p, [target, '--format', 'sarif'], capsys) for p in ('torch', 'jax')]
        assert docs[0][0] == docs[1][0] == text[0][0]
        ours, theirs = (_sarif_results(d[1]) for d in docs)
        assert ours['runs'][0]['results'] == theirs['runs'][0]['results']
        assert ours['runs'][0]['tool']['driver']['name'] == sarif.TOOL_NAME
        rules = [[r for r in doc['runs'][0]['tool']['driver']['rules'] if r['id'] != 'PT400']
                 for doc in (ours, theirs)]
        assert rules[0] == rules[1]


@pytest.mark.parametrize('flags', [
    ['--select', 'PT1,PT6'],
    ['--select', 'PT9', '--ignore', 'PT903,PT904'],
    ['--ignore', 'PT4,PT13'],
    ['--select', 'pt80'],
])
def test_cli_select_and_ignore_match_jax(flags, capsys):
    out = [_cli(p, [JAX_FIXTURES, '--format', 'json'] + flags, capsys) for p in ('torch', 'jax')]
    assert out[0][0] == out[1][0] == 1
    ours = _normalized_json(out[0][1])
    assert ours == _normalized_json(out[1][1])
    codes = {r['rule'] for r in ours}
    assert codes and 'PT400' not in codes


def test_cli_usage_errors_match_jax(capsys, tmp_path):
    for argv in (['--select', 'PX9'], ['--ignore', 'PT99'], [str(tmp_path / 'missing')]):
        assert _cli('torch', argv, capsys)[0] == _cli('jax', argv, capsys)[0] == cli.EXIT_USAGE


def test_cli_baseline_round_trip_matches_jax(capsys, tmp_path):
    target = os.path.join(JAX_FIXTURES, 'PT600', 'bad')
    written = {}
    for package in ('torch', 'jax'):
        path = str(tmp_path / (package + '.json'))
        rc, out, _ = _cli(package, [target, '--write-baseline', path], capsys)
        assert rc == 0 and 'written to' in out
        with open(path) as f:
            written[package] = json.load(f)
        rc, out, _ = _cli(package, [target, '--format', 'json', '--baseline', path], capsys)
        assert rc == 0
        assert {r['status'] for r in json.loads('[' + ','.join(out.splitlines()) + ']')} == \
            {'baselined'}
    assert written['torch'] == written['jax'] and written['torch']['entries']


def test_cli_rules_lists_the_jax_codes(capsys):
    listings = [_cli(p, ['--rules'], capsys) for p in ('torch', 'jax')]
    assert listings[0][0] == listings[1][0] == 0
    codes = [[line.split()[0] for line in out.splitlines()] for _, out, _ in listings]
    assert codes[0] == codes[1] == [c.code for c in analysis.ALL_CHECKERS]
    assert 'capture-purity' in listings[0][1]


def test_cli_cache_serves_the_second_run(capsys, tmp_path):
    cache_dir = str(tmp_path / 'cache')
    fresh = _cli('torch', [JAX_FIXTURES, '--format', 'json'], capsys)
    first = _cli('torch', [JAX_FIXTURES, '--format', 'json', '--cache', cache_dir], capsys)
    second = _cli('torch', [JAX_FIXTURES, '--format', 'json', '--cache', cache_dir], capsys)
    assert fresh[0] == first[0] == second[0] == 1
    assert fresh[1] == first[1] == second[1]
    assert ', 0 misses' in second[2] and ' 0 hits' in first[2]
    # and the JAX CLI's cached run over the same tree agrees
    theirs = _cli('jax', [JAX_FIXTURES, '--format', 'json', '--cache',
                          str(tmp_path / 'jax_cache')], capsys)
    ours = [r for r in _normalized_json(second[1]) if r['rule'] != 'PT400']
    assert ours == [r for r in _normalized_json(theirs[1]) if r['rule'] != 'PT400']


_ABBA_POOL = '''
import threading

class GrowablePool(object):
    def __init__(self):
        self._pool_lock = threading.Lock()

    def grow(self, vent):
        with self._pool_lock:
            vent.pause_inner()

    def grow_inner(self):
        with self._pool_lock:
            pass
'''

_ABBA_VENT = _ABBA_POOL.replace('GrowablePool', 'PausableVentilator').replace(
    '_pool_lock', '_vent_lock').replace('grow(self, vent)', 'pause(self, pool)').replace(
    'vent.pause_inner()', 'pool.grow_inner()').replace('grow_inner(self)', 'pause_inner(self)')


def _abba_tree(root):
    workers = root / 'workers'
    workers.mkdir(parents=True)
    (workers / 'pool.py').write_text(_ABBA_POOL)
    (workers / 'vent.py').write_text(_ABBA_VENT)
    return [(str(workers / n), 'workers/' + n) for n in ('pool.py', 'vent.py')]


def test_program_pass_is_cached_and_invalidated(tmp_path):
    entries = _abba_tree(tmp_path)
    cache_dir = str(tmp_path / 'cache')
    first = cache.run_analysis_incremental(entries, cache=cache.ResultCache(cache_dir))
    assert 'PT1300' in {f.code for f in first}
    assert [_same(f) for f in first] == [
        _same(f) for f in jax_cache.run_analysis_incremental(entries)]
    warm = cache.ResultCache(cache_dir)
    assert [f.to_dict() for f in cache.run_analysis_incremental(entries, cache=warm)] == \
        [f.to_dict() for f in first]
    assert warm.misses == 0
    (tmp_path / 'workers' / 'vent.py').write_text(_ABBA_VENT.replace('pool.grow_inner()',
                                                                     'pass'))
    third = cache.run_analysis_incremental(entries, cache=cache.ResultCache(cache_dir))
    assert 'PT1300' not in {f.code for f in third}
    # the changed subset alone cannot prove the cycle; the full listing does
    assert 'PT1300' not in {f.code for f in cache.run_analysis_incremental(entries[:1])}


def test_cache_fingerprint_digests_the_port_analysis_sources():
    fingerprint = cache.analysis_fingerprint()
    assert fingerprint != jax_cache.analysis_fingerprint()
    assert cache._fingerprint_memo == {os.path.join(PORT_DIR, 'analysis'): fingerprint}


def _git(cwd, *args):
    subprocess.run(['git', '-c', 'user.name=lint', '-c', 'user.email=lint@localhost',
                    '-c', 'init.defaultBranch=main'] + list(args),
                   cwd=str(cwd), check=True, capture_output=True, timeout=60)


def test_cli_changed_scans_the_changed_files(capsys, tmp_path, monkeypatch):
    repo = tmp_path / 'repo'
    pkg = repo / 'pkg'
    _abba_tree(pkg)
    (pkg / 'eq.py').write_text(textwrap.dedent(_EQ_ONLY.format(comment='', value='True')))
    _git(repo, 'init', '-q')
    _git(repo, 'add', '-A')
    _git(repo, 'commit', '-q', '-m', 'tree')
    monkeypatch.chdir(str(repo))
    # nothing changed: no per-file rule runs, and the program pass (the
    # PT13xx lints, over the whole listing) still reports the cycle
    runs = [_cli(p, ['pkg', '--changed', '--format', 'json'], capsys) for p in ('torch', 'jax')]
    assert runs[0][0] == runs[1][0] == 1
    assert _normalized_json(runs[0][1]) == _normalized_json(runs[1][1])
    assert {r['rule'] for r in _normalized_json(runs[0][1])} == {'PT1300'}
    assert '0 changed files scanned' in runs[0][2]
    # an untracked file and an edit: only they run the per-file rules
    (pkg / 'eq2.py').write_text(textwrap.dedent(_EQ_ONLY.format(comment='', value='False')))
    (pkg / 'workers' / 'pool.py').write_text(_ABBA_POOL + '\n')
    runs = [_cli(p, ['pkg', '--changed', '--format', 'json'], capsys) for p in ('torch', 'jax')]
    assert runs[0][0] == runs[1][0] == 1
    ours = _normalized_json(runs[0][1])
    assert ours == _normalized_json(runs[1][1])
    assert sorted({(r['path'], r['rule']) for r in ours}) == [
        ('eq2.py', 'PT600'), ('workers/pool.py', 'PT1300')]
    assert '2 changed files scanned' in runs[0][2]


def test_cli_module_runs_without_jax(tmp_path):
    """``python -m petastorm_tpu_torch.analysis`` imports nothing of JAX."""
    code = ('import runpy, sys\n'
            'sys.argv = ["x", {!r}, "--format", "sarif"]\n'
            'try:\n'
            '    runpy.run_module("petastorm_tpu_torch.analysis", run_name="__main__")\n'
            'except SystemExit as e:\n'
            '    rc = e.code\n'
            'loaded = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "petastorm_tpu"))\n'
            'assert not loaded, loaded\n'
            'sys.exit(rc)\n').format(os.path.join(JAX_FIXTURES, 'PT600', 'bad'))
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    doc = json.loads(out.stdout)
    assert doc['version'] == sarif.SARIF_VERSION and doc['$schema'] == sarif.SARIF_SCHEMA
    run = doc['runs'][0]
    assert [r['id'] for r in run['tool']['driver']['rules']] == \
        list(analysis.ALL_RULE_CODES) + ['PT000']
    assert [r['ruleId'] for r in run['results']] == ['PT600']
    assert run['tool']['driver']['rules'][run['results'][0]['ruleIndex']]['id'] == 'PT600'


# -- PT400: CUDA-graph capture purity --------------------------------------------------

#: (kind, the impure expression) of each form PT400 flags
_IMPURE = [
    ('clock', 'time.time()'), ('clock', 'time.perf_counter()'),
    ('host_rng', 'np.random.rand()'), ('host_rng', 'random.random()'),
    ('sync', 'y.item()'), ('sync', 'y.tolist()'), ('sync', 'y.cpu()'), ('sync', 'y.numpy()'),
    ('sync', 'torch.cuda.synchronize()'),
    ('reseed', 'torch.manual_seed(0)'), ('reseed', 'torch.cuda.manual_seed_all(0)'),
    ('reseed', 'gen.manual_seed(0)'), ('reseed', 'torch.Generator("cuda").manual_seed(0)'),
]

#: one capture of each context, with the impure expression at ``{expr}``
_CONTEXTS = {
    'graph_block': '''
        import random, time
        import numpy as np
        import torch

        def step(graph, x, gen):
            with torch.cuda.graph(graph):
                y = x * 2
                z = {expr}
            return y
    ''',
    'aliased_block': '''
        import random, time
        import numpy as np
        import torch
        from torch.cuda import graph as capture

        def step(g, x, gen):
            with capture(g), torch.no_grad():
                y = x * 2; z = {expr}
            return y
    ''',
    'graphed_callable': '''
        import random, time
        import numpy as np
        import torch

        def step(x):
            gen = None
            y = x * 2
            z = {expr}
            return y

        graphed = torch.cuda.make_graphed_callables((step,), ((torch.zeros(2),),))
    ''',
    'nested_def': '''
        import random, time
        import numpy as np
        import torch

        def step(x, gen):
            def inner():
                return {expr}
            y = x * 2; z = inner()
            return y

        graphed = torch.cuda.make_graphed_callables(step, (torch.zeros(2),))
    ''',
    'outside': '''
        import random, time
        import numpy as np
        import torch

        def step(graph, x, gen):
            y = x * 2
            z = {expr}
            with torch.cuda.graph(graph):
                y.mul_(2)
            return y
    ''',
}


def _pt400(text, relpath='ops/fixture.py'):
    src = core.SourceFile('<snippet>', relpath, textwrap.dedent(text))
    assert src.parse_error is None, src.parse_error
    return [(f.line, f.code, f.message) for f in core.run_checkers([CapturePurityChecker()],
                                                                      [src])]


@pytest.mark.parametrize('context', sorted(_CONTEXTS))
@pytest.mark.parametrize('kind,expr', _IMPURE, ids=[e for _, e in _IMPURE])
def test_pt400_flags_host_work_inside_a_capture(context, kind, expr):
    findings = _pt400(_CONTEXTS[context].format(expr=expr))
    if context == 'outside':
        assert findings == []
        return
    line = next(i for i, text in enumerate(textwrap.dedent(_CONTEXTS[context]).splitlines(), 1)
                if '{expr}' in text)
    assert [(at, code) for at, code, _ in findings] == [(line, 'PT400')]
    message = findings[0][2]
    assert {'clock': 'freezes', 'host_rng': 'freezes', 'sync': 'waits for the device',
            'reseed': 'reseeds a generator'}[kind] in message
    assert ('capture block' in message) == context.endswith('block')


def test_pt400_allows_in_place_writes_to_static_buffers():
    """The JAX rule's argument writes are the intended form of a capture:
    the same writes in a jitted function are JAX PT400 findings."""
    captured = '''
        import torch

        def step(graph, static_in, static_out, params):
            with torch.cuda.graph(graph):
                static_out[...] = static_in * 2
                params[0].add_(static_out.mean())
                static_out[0] += 1
    '''
    assert _pt400(captured) == []
    jitted = '''
        import jax

        @jax.jit
        def step(static_in, static_out):
            static_out[0] = static_in * 2
    '''
    src = jax_core.SourceFile('<snippet>', 'ops/fixture.py', textwrap.dedent(jitted))
    assert [f.code for f in JaxPurityChecker().check(src)] == ['PT400']
    assert _pt400(jitted) == []


def test_pt400_noqa_suppresses_a_capture_finding():
    text = _CONTEXTS['graph_block'].format(expr='time.time()  # noqa: PT400 - a capture stamp')
    assert _pt400(text) == []


def test_pt400_scope_is_the_jax_one():
    """The capture of the port's graphed train step (``models/train.py``)
    stands outside the scope, as the JAX package's one ``jax.jit``
    (``petastorm_tpu/models/train.py``) stands outside the JAX rule's; the
    checker run over the file directly finds the capture, and it is pure."""
    checker = CapturePurityChecker()
    assert not checker.matches_path('models/train.py')
    assert not JaxPurityChecker().matches_path('models/train.py')
    assert checker.matches_path('ops/augment.py') and checker.matches_path('torch/infeed.py')
    path = os.path.join(PORT_DIR, 'models', 'train.py')
    with open(path) as f:
        src = core.SourceFile(path, 'models/train.py', f.read())
    regions = _captured_regions(src.tree)
    assert [where.split(' at line')[0] for where, _ in regions] == ['the capture block']
    assert list(checker.check(src)) == []


def test_pt400_fixtures_name_every_probe():
    """``chip_smoke.py``'s ``lint_checks`` captures each ``<kind>_block`` and
    ``<kind>_step`` of the fixtures on the card: every bad one is flagged
    (once, inside it), no clean one is, each step has its ``graph_`` maker,
    and the bad ones cover the four kinds in both capture forms."""
    import chip_smoke

    for side in ('bad', 'clean'):
        probes = chip_smoke._flagged_probes(side)
        fixture = chip_smoke._probe_fixture(side)
        assert probes
        for name, codes in probes.items():
            assert codes == (['PT400'] if side == 'bad' else []), name
            if name.endswith('_step'):
                assert callable(getattr(fixture, 'graph_' + name)), name
        if side == 'bad':
            assert sorted(probes) == sorted('{}_{}'.format(kind, form) for kind in (
                'clock', 'host_rng', 'sync', 'reseed') for form in ('block', 'step'))


# -- the meta-gate ---------------------------------------------------------------------

@pytest.mark.parametrize('code', analysis.ALL_RULE_CODES)
def test_port_rule_fires_on_its_fixture_and_stays_silent_on_the_clean_twin(code):
    bad = os.path.join(PORT_FIXTURES, code, 'bad')
    clean = os.path.join(PORT_FIXTURES, code, 'clean')
    assert os.path.isdir(bad) and os.path.isdir(clean), (
        'rule {} has no fixture pair under tests/torch_lint_fixtures/{}/'.format(code, code))
    assert code in {f.code for f in analysis.run_analysis([bad])}
    assert code not in {f.code for f in analysis.run_analysis([clean])}
    if code != 'PT400':
        # the port's pair is the JAX pair with the package renamed
        for side, root in (('bad', bad), ('clean', clean)):
            assert [_same(f) for f in analysis.run_analysis([root], keep_suppressed=True)] == \
                [_same(f) for f in analysis.run_analysis(
                    [os.path.join(JAX_FIXTURES, code, side)], keep_suppressed=True)]


def test_port_fixture_root_has_no_orphan_directories():
    dirs = {d for d in os.listdir(PORT_FIXTURES) if os.path.isdir(os.path.join(PORT_FIXTURES, d))}
    assert dirs == set(analysis.ALL_RULE_CODES)
