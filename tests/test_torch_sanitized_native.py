"""The port's sanitizer lane (``PSTPU_SANITIZE``), twin of
``tests/test_sanitized_native.py``.

The release replay (``tests/test_torch_native_reader.py``) asserts the
error-sentinel contract; an out-of-bounds read the release build happens to
survive still passes it. This lane builds the port's three libraries (the
Parquet reader, the image decoder and the shm ring) with
``PSTPU_SANITIZE=address,undefined`` into their own ``.san.so`` files and
replays ``petastorm_tpu_torch/test_util/native_corpus.py`` through them: the
fuzz corpus, the corrupt-chunk regressions (the map of bools the JAX corpus
cannot hold among them), the compressed frames, the page statistics, PNG
cells and resizes, and the ring and lifetime cycles. Any over-read,
overflow or undefined behaviour aborts the subprocess, which imports the
port alone (an instrumented library loads only with ``libasan`` and
``libubsan`` preloaded).

Skipped where the toolchain lacks the gcc sanitizer runtimes.
"""

import json
import os
import subprocess
import sys

import pytest

from petastorm_tpu import native as jax_native
from petastorm_tpu.native import build as jax_build
from petastorm_tpu_torch.native import build as native_build
from petastorm_tpu_torch.test_util import native_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SANITIZE = 'address,undefined'


@pytest.fixture(scope='module')
def sanitizer_env():
    preload = native_build.sanitizer_preload()
    if preload is None:
        pytest.skip('gcc sanitizer runtimes not installed')
    env = dict(os.environ)
    env.update({
        'PSTPU_SANITIZE': SANITIZE,
        'LD_PRELOAD': preload,
        # leak detection sees the interpreter's arena noise, not ours; any
        # finding must abort, so the subprocess exits non-zero
        'ASAN_OPTIONS': 'detect_leaks=0:abort_on_error=1',
        'UBSAN_OPTIONS': 'halt_on_error=1:print_stacktrace=1',
        'PYTHONPATH': REPO,
        'PSTPU_FLIGHT': '0',
    })
    return env


def _run(code, env, timeout=560):
    return subprocess.run([sys.executable, '-c', code], env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


# -- fast cases: the token and the names --------------------------------------

@pytest.mark.parametrize('raw, tokens', [
    ('', ()), ('  ', ()), ('address', ('address',)), ('address,undefined', ('address', 'undefined')),
    (' undefined , address ', ('undefined', 'address')), ('leak,thread', ('leak', 'thread'))])
def test_sanitize_tokens_as_jax_reads_them(monkeypatch, raw, tokens):
    monkeypatch.setenv('PSTPU_SANITIZE', raw)
    assert native_build.sanitize_tokens() == tokens == jax_build.sanitize_tokens()


@pytest.mark.parametrize('raw', ['address,bogus', 'adress', 'undefined,memory'])
def test_an_unknown_sanitizer_refuses_to_build(monkeypatch, raw):
    monkeypatch.setenv('PSTPU_SANITIZE', raw)
    bad = [t for t in raw.split(',') if t not in native_build._SANITIZERS][0]
    for fn in (native_build.sanitize_tokens, native_build.build, native_build.build_img,
               native_build.build_ring):
        with pytest.raises(RuntimeError, match=bad):
            fn()


def test_sanitized_libraries_are_named_beside_the_release_ones(monkeypatch):
    monkeypatch.delenv('PSTPU_SANITIZE', raising=False)
    outputs = (native_build.OUTPUT, native_build.IMG_OUTPUT, native_build.RING_OUTPUT)
    assert [native_build._sanitized_output(o) for o in outputs] == list(outputs)
    assert native_build._sanitize_flags() == []
    assert native_build._sanitized_stamp('s') == 's'
    monkeypatch.setenv('PSTPU_SANITIZE', SANITIZE)
    for out in outputs:
        san = native_build._sanitized_output(out)
        assert san == out[:-len('.so')] + '.san.so'
        assert os.path.dirname(san) == native_build.BUILD_DIR
        # the JAX package names its sanitized libraries the same way
        assert os.path.basename(jax_build._sanitized_output('/x/' + os.path.basename(out))) \
            == os.path.basename(san)
    assert native_build._sanitize_flags() == jax_build._sanitize_flags() == [
        '-fsanitize=address,undefined', '-fno-omit-frame-pointer', '-g', '-O1']
    assert native_build._sanitized_stamp('s') == 'san[address,undefined]:s'
    assert jax_build._sanitized_stamp(lambda: 's')() == 'san[address,undefined]:s'


def test_release_commands_and_stamps_are_unchanged(monkeypatch):
    """Without ``PSTPU_SANITIZE`` the three command lines hold no sanitizer
    flag, so the release stamps (which hold the command) stay as they were."""
    monkeypatch.delenv('PSTPU_SANITIZE', raising=False)
    for cmd in (native_build._reader_command('OUT'), native_build._ring_command('OUT'),
                native_build._command('OUT', [])):
        assert not any('sanitize' in part or part in ('-g', '-O1') for part in cmd), cmd
    monkeypatch.setenv('PSTPU_SANITIZE', SANITIZE)
    for cmd in (native_build._reader_command('OUT'), native_build._ring_command('OUT'),
                native_build._command('OUT', [])):
        assert '-fsanitize=address,undefined' in cmd, cmd


def test_map_of_bools_page_is_refused_by_the_release_reader():
    """The corrupt-chunk regressions through the release reader, the page
    only the port's corpus holds among them (the JAX scanner spins on its
    map of bools), in a child with a time limit: a regression hangs instead
    of failing."""
    code = '\n'.join([
        'from petastorm_tpu_torch import native',
        'from petastorm_tpu_torch.test_util import native_corpus',
        'native_corpus.replay_corrupt_chunk_regressions(native._load_library())',
        'print("REFUSED")'])
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env=dict(os.environ, PSTPU_FLIGHT='0'))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == 'REFUSED'


def test_corpus_pages_are_the_jax_corpus_pages():
    """The builders shared with the JAX corpus write the same bytes."""
    from petastorm_tpu.test_util import native_corpus as jax_corpus

    assert list(native_corpus.fuzz_corpus()) == list(jax_corpus.fuzz_corpus())
    assert native_corpus.overflow_dict_chunk() == jax_corpus.overflow_dict_chunk()
    assert native_corpus.v2_overdeclared_levels_chunk() == \
        jax_corpus.v2_overdeclared_levels_chunk()
    assert [c[:3] for c in native_corpus.compressed_frame_corpus()] == \
        [c[:3] for c in jax_corpus.compressed_frame_corpus()]
    assert native_corpus.page_stats_corpus() == jax_corpus.page_stats_corpus()


def test_release_replay_matches_the_jax_kernels():
    """The compressed frames both corpora hold, through the port's release
    reader and the JAX package's: the same statuses and bytes."""
    from petastorm_tpu.native import fused as jax_fused
    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.native import fused

    ours, theirs = native._load_library(), jax_native._load_library()
    for data, codec, expect_ok, vals in native_corpus.compressed_frame_corpus():
        chunk = native_corpus.np.frombuffer(data, dtype=native_corpus.np.uint8)
        got = []
        for lib, mod in ((ours, fused), (theirs, jax_fused)):
            plan = mod.ColumnPlan('c')
            plan.codec, plan.itemsize = codec, 8
            plan.phys_dtype = plan.out_dtype = native_corpus.np.dtype(native_corpus.np.int64)
            plan.out_shape, plan.chunk_len, plan.out_bound = (4,), chunk.size, len(vals)
            out = native_corpus.np.zeros(len(vals), native_corpus.np.uint8)
            (res,) = mod.read_into(lib, [chunk], [plan], 4, out, [0])
            got.append((res[0], bytes(out)))
        assert got[0] == got[1]
        assert (got[0][0] == 0) == expect_ok


# -- the lane ------------------------------------------------------------------

def test_sanitized_build_coexists_with_release(sanitizer_env):
    """The ring's sanitized build lands in its own ``.san.so`` and stamp and
    leaves the release library and stamp as they were."""
    release = native_build.RING_OUTPUT
    native_build.build_ring()
    with open(release + '.stamp') as f:
        release_stamp = f.read()
    release_mtime = os.stat(release).st_mtime_ns
    proc = _run('from petastorm_tpu_torch.native import build\nprint(build.build_ring())',
                sanitizer_env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    san = proc.stdout.strip().splitlines()[-1]
    assert san == release[:-len('.so')] + '.san.so' and os.path.exists(san)
    with open(san + '.stamp') as f:
        assert f.read().startswith('san[{}]:'.format(SANITIZE))
    with open(release + '.stamp') as f:
        assert f.read() == release_stamp
    assert os.stat(release).st_mtime_ns == release_mtime


def test_sanitized_replay_of_the_corpus(sanitizer_env):
    """The lane: every library built instrumented and the whole corpus
    replayed through them under ASan and UBSan, cleanly."""
    proc = _run('\n'.join([
        'import json, sys',
        'from petastorm_tpu_torch.test_util import native_corpus',
        'report = native_corpus.replay_all()',
        "report['jax_loaded'] = sorted(m for m in sys.modules",
        "                             if m.split('.')[0] in ('jax', 'petastorm_tpu'))",
        'print(json.dumps(report))']), sanitizer_env)
    assert proc.returncode == 0, 'sanitized replay failed\nstdout:\n{}\nstderr:\n{}'.format(
        proc.stdout, proc.stderr[-6000:])
    for marker in ('AddressSanitizer', 'runtime error'):
        assert marker not in proc.stderr, proc.stderr[-6000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(path.endswith('.san.so') for path in report['libraries'].values()), report
    assert report['items'] == {'fuzz': 210, 'regressions': 22, 'png': 15, 'ring_cycles': 2}
    assert report['jax_loaded'] == []  # the subprocess imported the port alone


_USE_AFTER_RELEASE = '''\
import os
import numpy as np
from petastorm_tpu_torch.native import shm_ring
from petastorm_tpu_torch.native.lifetime import RingBorrowLedger, SlotRegistry

assert os.environ.get('PSTPU_LIFETIME_GUARD') == '1'
ring = shm_ring.ShmRing.create('/pstpu_torch_uar_{}'.format(os.getpid()), 64 * 1024)
# an 8 KiB payload covers at least one whole page to protect
assert ring.try_write(b'v' * 8192)
view, span, borrowed = ring.try_read_zero_copy()
assert borrowed, 'expected an in-place borrowed view'
slot = RingBorrowLedger(ring, registry_=SlotRegistry()).take(view, span, borrowed)
arr = np.frombuffer(view, dtype=np.uint8)
slot.adopt(arr)
slot.seal()
slot.force_reclaim()  # over the live borrow: PROT_NONE
print('PRE-TOUCH', flush=True)
print(int(arr.sum()))  # must die here
print('POST-TOUCH', flush=True)
'''


def test_sanitized_use_after_release_is_caught(sanitizer_env):
    """Touching a force-reclaimed borrow of the sanitized ring dies at the
    guard page; it never reads recycled ring bytes."""
    proc = _run(_USE_AFTER_RELEASE, dict(sanitizer_env, PSTPU_LIFETIME_GUARD='1'))
    assert 'PRE-TOUCH' in proc.stdout, proc.stdout + proc.stderr
    assert 'POST-TOUCH' not in proc.stdout, proc.stdout
    assert proc.returncode != 0
