"""Build the batched image decoder (``image_codec.cpp``) with g++.

Twin of ``build_img`` in ``petastorm_tpu/native/build.py``: ``-O3
-march=native`` (the library is always compiled on the machine that runs
it), a stamp of the source hash, the CPU and the command line beside the
library so that any change rebuilds it, and an ``flock`` so that concurrent
processes (test workers) build it once. The library goes to
``.torch_build/native/`` at the root of the checkout, never into the package.

The source builds with whatever image libraries the host has: the compiler's
``__has_include`` decides, and :func:`_features` reads its decision back
(``g++ -dM -E``) to pick the libraries to link. Without libdeflate the PNG
path links the ``libz.so.1`` that CPython's zlib module loads.

Run ``python -m petastorm_tpu_torch.native.build`` to build it ahead of use.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
IMG_SOURCE = os.path.join(_HERE, 'image_codec.cpp')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), '.torch_build', 'native')
IMG_OUTPUT = os.path.join(BUILD_DIR, 'libpstpu_torch_img.so')

#: the source's optional libraries: macro -> the link flag it needs
_LIBRARIES = {'PSTPU_HAVE_JPEG': '-ljpeg', 'PSTPU_HAVE_PNG': '-lpng16',
              'PSTPU_HAVE_DEFLATE': '-ldeflate'}
_BASE_FLAGS = ['g++', '-O3', '-march=native', '-std=c++17', '-shared', '-fPIC']


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


def _stamp(defines):
    with open(IMG_SOURCE, 'rb') as f:
        source = hashlib.sha256(f.read()).hexdigest()
    return '{}:{}:{}'.format(source, _cpu_fingerprint(), ' '.join(_command('OUT', defines)))


def _is_fresh(output, stamp):
    try:
        with open(output + '.stamp') as f:
            return os.path.exists(output) and f.read() == stamp
    except OSError:
        return False


def build_img(force=False, quiet=True, output=IMG_OUTPUT, without=()):
    """Compile the decoder unless a fresh build is in place; returns its path.

    ``without`` names libraries to leave out even where the host has them
    (``'jpeg'``, ``'png'``, ``'deflate'``): a reduced library, as a host
    without them would build, for tests of that configuration."""
    defines = ['-DPSTPU_HAVE_{}=0'.format(name.upper()) for name in without]
    unknown = [d for d in defines if d.split('=')[0][2:] not in _LIBRARIES]
    if unknown:
        raise ValueError('unknown libraries in without={!r}'.format(without))
    stamp = _stamp(defines)
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
            cmd = _command(tmp_out, defines)
            if not quiet:
                print('building image codec:', ' '.join(cmd))
            result = subprocess.run(cmd, capture_output=True, text=True)
            if result.returncode != 0:
                if os.path.exists(tmp_out):
                    os.unlink(tmp_out)
                raise RuntimeError('image codec build failed:\n{}'.format(result.stderr))
            # a process that already loaded the old library keeps its inode
            os.replace(tmp_out, output)
            with open(output + '.stamp', 'w') as f:
                f.write(stamp)
            return output
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


if __name__ == '__main__':
    print('built', build_img(force='--force' in sys.argv, quiet=False))
