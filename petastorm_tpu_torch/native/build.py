"""Build the port's native libraries with g++, at first use.

Three targets, each the twin of one in ``petastorm_tpu/native/build.py``:

- :func:`build`: the Parquet row-group reader (``rowgroup_reader.cpp``),
  ``-O2 -std=c++20``, compiled against the Arrow and Parquet C++ libraries
  that the installed pyarrow wheel bundles. The wheel ships versioned
  sonames only (``libarrow.so.2400``), so they are linked by exact name with
  an rpath into the wheel's directory, both read from pyarrow at build time.
  A pyarrow upgrade, another Python, or an edit of the source rebuilds it.
- :func:`build_img`: the batched image decoder (``image_codec.cpp``), ``-O3
  -march=native`` (the library is always compiled on the machine that runs
  it), rebuilt when the source, the CPU or the command line changes. The
  source builds with whatever image libraries the host has: the compiler's
  ``__has_include`` decides, and :func:`_features` reads its decision back
  (``g++ -dM -E``) to pick the libraries to link. Without libdeflate the PNG
  path links the ``libz.so.1`` that CPython's zlib module loads.
- :func:`build_ring`: the shared-memory ring of the process pool
  (``shm_ring.cpp``), ``-O2 -std=c++17`` with no third-party headers
  (``-lrt``: ``shm_open`` lives in librt before glibc 2.34), rebuilt when the
  source or the command line changes.

All go to ``.torch_build/native/`` at the root of the checkout, never into
the package, with a stamp beside each library and an ``flock`` so that
concurrent processes (test workers) build it once.

Run ``python -m petastorm_tpu_torch.native.build`` to build them ahead of use.
"""

from __future__ import annotations

import glob
import hashlib
import os
import platform
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, 'rowgroup_reader.cpp')
IMG_SOURCE = os.path.join(_HERE, 'image_codec.cpp')
RING_SOURCE = os.path.join(_HERE, 'shm_ring.cpp')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), '.torch_build', 'native')
OUTPUT = os.path.join(BUILD_DIR, 'libpstpu_torch.so')
IMG_OUTPUT = os.path.join(BUILD_DIR, 'libpstpu_torch_img.so')
# a file name of its own: the JAX package's ring library exports the same
# symbols, and each package must load its own under ctypes' RTLD_LOCAL
RING_OUTPUT = os.path.join(BUILD_DIR, 'libpstpu_torch_ring.so')

#: the image source's optional libraries: macro -> the link flag it needs
_LIBRARIES = {'PSTPU_HAVE_JPEG': '-ljpeg', 'PSTPU_HAVE_PNG': '-lpng16',
              'PSTPU_HAVE_DEFLATE': '-ldeflate'}
_BASE_FLAGS = ['g++', '-O3', '-march=native', '-std=c++17', '-shared', '-fPIC']


def _source_hash(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cpu_fingerprint():
    """Model name and ISA flags of cpu0: with ``-march=native`` a library
    carried onto another CPU must rebuild instead of faulting."""
    ident = [platform.machine()]
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith(('model name', 'flags')):
                    ident.append(line.strip())
                if line == '\n' and len(ident) > 1:
                    break
    except OSError:
        pass
    return hashlib.sha256('\n'.join(ident).encode()).hexdigest()[:16]


def _is_fresh(output, stamp):
    try:
        with open(output + '.stamp') as f:
            return os.path.exists(output) and f.read() == stamp
    except OSError:
        return False


def _build_target(output, stamp, make_cmd, label, force, quiet):
    """Compile ``output`` unless a build with this ``stamp`` is in place.

    An ``flock`` lets one process at a time compile, the others then find
    the fresh build; the compiler writes a per-process temporary that is renamed into place, so a
    process that already loaded the old library keeps its inode.
    ``make_cmd(tmp_out)`` returns the compiler's argv."""
    if not force and _is_fresh(output, stamp):
        return output
    import fcntl
    os.makedirs(os.path.dirname(output), exist_ok=True)
    with open(output + '.lock', 'w') as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if not force and _is_fresh(output, stamp):  # built while we waited
                return output
            tmp_out = '{}.tmp.{}'.format(output, os.getpid())
            cmd = make_cmd(tmp_out)
            if not quiet:
                print('building {}:'.format(label), ' '.join(cmd))
            result = subprocess.run(cmd, capture_output=True, text=True)
            if result.returncode != 0:
                if os.path.exists(tmp_out):
                    os.unlink(tmp_out)
                raise RuntimeError('{} build failed:\n{}'.format(label, result.stderr))
            os.replace(tmp_out, output)
            with open(output + '.stamp', 'w') as f:
                f.write(stamp)
            return output
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


# -- the Parquet row-group reader ------------------------------------------------

def arrow_paths():
    """``(include dir, library dirs, libarrow soname, libparquet soname)`` of
    the installed pyarrow wheel."""
    import pyarrow
    include = pyarrow.get_include()
    libdirs = pyarrow.get_library_dirs()
    arrow_lib = parquet_lib = None
    for d in libdirs:
        for so in glob.glob(os.path.join(d, 'libarrow.so*')):
            arrow_lib = os.path.basename(so)
        for so in glob.glob(os.path.join(d, 'libparquet.so*')):
            parquet_lib = os.path.basename(so)
    if not arrow_lib or not parquet_lib:
        raise RuntimeError('pyarrow wheel does not bundle libarrow/libparquet '
                           '(searched {})'.format(libdirs))
    return include, libdirs, arrow_lib, parquet_lib


def _reader_command(tmp_out):
    include, libdirs, arrow_lib, parquet_lib = arrow_paths()
    cmd = ['g++', '-O2', '-std=c++20', '-shared', '-fPIC', SOURCE, '-I{}'.format(include)]
    for d in libdirs:
        cmd += ['-L{}'.format(d), '-Wl,-rpath,{}'.format(d)]
    return cmd + ['-l:{}'.format(arrow_lib), '-l:{}'.format(parquet_lib), '-o', tmp_out]


def build(force=False, quiet=True):
    """Compile the row-group reader unless a fresh build is in place; returns
    its path. The stamp holds pyarrow's version, Python's, the source hash
    and the command line (which names the wheel's directory and sonames)."""
    import pyarrow
    stamp = '{}:{}:{}:{}'.format(pyarrow.__version__, sys.version_info[:2],
                                 _source_hash(SOURCE), ' '.join(_reader_command('OUT')))
    return _build_target(OUTPUT, stamp, _reader_command, 'native reader', force, quiet)


# -- the batched image decoder ---------------------------------------------------

def _features(defines):
    """``{macro: 0 or 1}`` as the compiler decides them for this host, with
    ``defines`` (``['-DPSTPU_HAVE_JPEG=0', ...]``) applied."""
    out = subprocess.run(_BASE_FLAGS[:1] + ['-std=c++17', '-dM', '-E'] + defines + [IMG_SOURCE],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError('image codec preprocessing failed:\n{}'.format(out.stderr))
    found = {}
    for line in out.stdout.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[1] in _LIBRARIES:
            found[parts[1]] = int(parts[2])
    return found


def _command(tmp_out, defines):
    features = _features(defines)
    libs = [flag for macro, flag in _LIBRARIES.items() if features.get(macro)]
    if not features.get('PSTPU_HAVE_DEFLATE'):
        libs.append('-l:libz.so.1')
    return _BASE_FLAGS + defines + [IMG_SOURCE] + libs + ['-o', tmp_out]


def build_img(force=False, quiet=True, output=IMG_OUTPUT, without=()):
    """Compile the decoder unless a fresh build is in place; returns its path.

    ``without`` names libraries to leave out even where the host has them
    (``'jpeg'``, ``'png'``, ``'deflate'``): a reduced library, as a host
    without them would build, for tests of that configuration."""
    defines = ['-DPSTPU_HAVE_{}=0'.format(name.upper()) for name in without]
    unknown = [d for d in defines if d.split('=')[0][2:] not in _LIBRARIES]
    if unknown:
        raise ValueError('unknown libraries in without={!r}'.format(without))
    stamp = '{}:{}:{}'.format(_source_hash(IMG_SOURCE), _cpu_fingerprint(),
                              ' '.join(_command('OUT', defines)))
    return _build_target(output, stamp, lambda tmp_out: _command(tmp_out, defines),
                         'image codec', force, quiet)


# -- the shared-memory ring -------------------------------------------------------

def _ring_command(tmp_out):
    return ['g++', '-O2', '-std=c++17', '-shared', '-fPIC', RING_SOURCE, '-lrt', '-o', tmp_out]


def build_ring(force=False, quiet=True):
    """Compile the process pool's shared-memory ring unless a fresh build is
    in place; returns its path. The stamp holds the source hash and the
    command line."""
    stamp = '{}:{}'.format(_source_hash(RING_SOURCE), ' '.join(_ring_command('OUT')))
    return _build_target(RING_OUTPUT, stamp, _ring_command, 'shm ring', force, quiet)


if __name__ == '__main__':
    force = '--force' in sys.argv
    print('built', build(force=force, quiet=False))
    print('built', build_img(force=force, quiet=False))
    print('built', build_ring(force=force, quiet=False))
