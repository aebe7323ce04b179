"""Incremental runs for the linter: ``--changed`` file selection and a
per-file result cache.

The full pass re-parses and re-walks every file on every invocation; in the
edit loop that is almost all wasted work — a file's findings depend only on
inputs that rarely change. This module makes the dependency set explicit and
keys a result cache on it.

**Cache key** (the invalidation contract; also documented in
docs/analysis.md):

* the file's root-relative path and its content bytes (a rename or edit is a
  new key — renames matter because ``scope`` patterns and noqa semantics
  match on the path);
* the content of every sibling ``*.cpp``/``*.cc`` in the file's directory —
  the ABI/C++ conformance passes (PT90x) check a Python file *against* its
  native sources, so editing ``shm_ring.cpp`` must invalidate
  ``shm_ring.py``'s entry even though its bytes are unchanged;
* a fingerprint of the ``petastorm_tpu_torch.analysis`` package itself (every
  ``.py`` under it, including ``protocol/``) — editing any checker, or this
  module, flushes the whole cache.

A per-path ``(mtime_ns, size)`` index short-circuits the content hash for
untouched files, so a warm no-op run does one ``stat`` per file. The index
is advisory only: a stale index entry can at worst cause a re-hash, never a
stale result, because the entry files themselves are addressed by content
key.

**What is stored**: the file's findings with ``keep_suppressed=True`` and NO
baseline applied. Baseline absorption and ``--select``/``--ignore`` are view
filters over the analysis, not part of it — they are re-applied on every
run, so switching flags never needs a re-scan and never poisons the cache.

**The whole-program pass** (the PT13xx race lints) does not fit per-file
caching — its findings depend on every in-scope file at once. It gets one
content-addressed entry instead, keyed by :func:`program_pass_key` (the
analysis fingerprint plus relpath+bytes of every file matching the program
checkers' scope). A warm run costs one hash sweep over the scoped files and
one JSON read; a ``--changed`` run passes the full listing via
``program_entries`` so cross-module properties are never derived from a
subset.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess

from petastorm_tpu_torch.analysis.core import Finding, SourceFile, run_checkers

_SOURCE_EXTS = ('.py', '.cpp', '.cc')
_INDEX_NAME = 'index.json'


# -- file selection ---------------------------------------------------------

def iter_file_entries(paths):
    """``[(abspath, relpath)]`` for every source file under ``paths`` —
    the same listing :func:`core.collect_sources` loads, without reading
    the files."""
    from petastorm_tpu_torch.analysis.core import _SKIP_DIRS
    entries = []
    for root in paths:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            entries.append((root, os.path.basename(root)))
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(_SOURCE_EXTS):
                    full = os.path.join(dirpath, fn)
                    entries.append((full, os.path.relpath(full, root)))
    return entries


def changed_file_entries(paths):
    """The subset of :func:`iter_file_entries` that git considers changed:
    tracked files differing from HEAD (staged or not) plus untracked
    non-ignored files. Relpaths stay relative to the matching scan root, so
    scope patterns, noqa reporting, and baseline paths behave exactly as in
    a full run. Raises ``RuntimeError`` outside a work tree."""
    try:
        out = subprocess.run(
            ['git', 'rev-parse', '--show-toplevel'],
            capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError('--changed needs a git work tree: {}'.format(e))
    top = out.stdout.strip()
    changed = set()
    for cmd in (['git', '-C', top, 'diff', '--name-only', 'HEAD', '--'],
                ['git', '-C', top, 'ls-files', '--others',
                 '--exclude-standard']):
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode == 0:
            changed.update(line.strip() for line in res.stdout.splitlines()
                           if line.strip())
    changed_abs = {os.path.abspath(os.path.join(top, p)) for p in changed}
    return [(full, rel) for full, rel in iter_file_entries(paths)
            if full in changed_abs]


# -- the keying scheme ------------------------------------------------------

_fingerprint_memo = {}


def analysis_fingerprint():
    """sha256 over every ``.py`` source of the analysis package (sorted
    relpath + bytes). Memoized per process; editing any checker produces a
    new fingerprint and therefore a cold cache."""
    pkg_dir = os.path.dirname(os.path.abspath(__file__))
    if pkg_dir in _fingerprint_memo:
        return _fingerprint_memo[pkg_dir]
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        dirnames[:] = sorted(d for d in dirnames if d != '__pycache__')
        for fn in sorted(filenames):
            if not fn.endswith('.py'):
                continue
            full = os.path.join(dirpath, fn)
            h.update(os.path.relpath(full, pkg_dir).encode())
            with open(full, 'rb') as f:
                h.update(f.read())
    _fingerprint_memo[pkg_dir] = h.hexdigest()
    return _fingerprint_memo[pkg_dir]


def _sibling_native_digest(dirpath, memo):
    """sha256 over the ``*.cpp``/``*.cc`` sources in ``dirpath`` (the PT90x
    conformance inputs of any Python file living there)."""
    if dirpath in memo:
        return memo[dirpath]
    h = hashlib.sha256()
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        names = []
    for fn in names:
        if fn.endswith(('.cpp', '.cc')):
            h.update(fn.encode())
            try:
                with open(os.path.join(dirpath, fn), 'rb') as f:
                    h.update(f.read())
            except OSError:
                pass
    memo[dirpath] = h.hexdigest()
    return memo[dirpath]


def file_key(abspath, relpath, sibling_memo):
    """The content-addressed cache key of one file's findings."""
    h = hashlib.sha256()
    h.update(analysis_fingerprint().encode())
    h.update(relpath.replace(os.sep, '/').encode())
    with open(abspath, 'rb') as f:
        h.update(f.read())
    h.update(_sibling_native_digest(os.path.dirname(abspath),
                                    sibling_memo).encode())
    return h.hexdigest()


# -- the cache itself -------------------------------------------------------

def _finding_from_dict(d):
    return Finding(path=d['path'], line=int(d['line']), code=d['rule'],
                   message=d['message'], snippet=d.get('snippet', ''),
                   status=d.get('status', 'open'))


class ResultCache(object):
    """Content-addressed per-file finding store under one directory.

    Layout: ``<key>.json`` holds one file's serialized findings;
    ``index.json`` maps relpath → ``(mtime_ns, size, key)`` so untouched
    files skip the content hash. Everything is advisory — deleting the
    directory is always safe and merely makes the next run cold."""

    def __init__(self, cache_dir):
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self._sibling_memo = {}
        self._sibling_stamp_memo = {}
        self._index = {}
        self._index_dirty = False
        try:
            with open(os.path.join(cache_dir, _INDEX_NAME)) as f:
                self._index = json.load(f)
        except (OSError, ValueError):
            self._index = {}

    def _sibling_stamp(self, dirpath):
        # the fast path must go stale whenever the CONTENT key would: a
        # file's findings also depend on its sibling native sources (PT90x),
        # so their stats are part of the stamp
        if dirpath in self._sibling_stamp_memo:
            return self._sibling_stamp_memo[dirpath]
        out = []
        try:
            names = sorted(os.listdir(dirpath))
        except OSError:
            names = []
        for fn in names:
            if fn.endswith(('.cpp', '.cc')):
                try:
                    st = os.stat(os.path.join(dirpath, fn))
                    out.append([fn, st.st_mtime_ns, st.st_size])
                except OSError:
                    pass
        self._sibling_stamp_memo[dirpath] = out
        return out

    def _key_for(self, abspath, relpath):
        rel = relpath.replace(os.sep, '/')
        try:
            st = os.stat(abspath)
            stamp = [st.st_mtime_ns, st.st_size,
                     self._sibling_stamp(os.path.dirname(abspath))]
        except OSError:
            stamp = None
        entry = self._index.get(rel)
        if entry is not None and stamp is not None and entry[:3] == stamp:
            return entry[3], stamp
        return file_key(abspath, relpath, self._sibling_memo), stamp

    def lookup(self, abspath, relpath):
        """Cached findings for the file as it is NOW, or None."""
        key, stamp = self._key_for(abspath, relpath)
        try:
            with open(os.path.join(self.dir, key + '.json')) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return None
        self.hits += 1
        self._remember(relpath, stamp, key)
        return [_finding_from_dict(d) for d in payload]

    def store(self, abspath, relpath, findings):
        key, stamp = self._key_for(abspath, relpath)
        self.misses += 1
        tmp = os.path.join(self.dir, key + '.json.tmp')
        with open(tmp, 'w') as f:
            json.dump([fi.to_dict() for fi in findings], f)
        os.replace(tmp, os.path.join(self.dir, key + '.json'))
        self._remember(relpath, stamp, key)

    def _remember(self, relpath, stamp, key):
        if stamp is not None:
            self._index[relpath.replace(os.sep, '/')] = stamp + [key]
            self._index_dirty = True

    def flush_index(self):
        if not self._index_dirty:
            return
        tmp = os.path.join(self.dir, _INDEX_NAME + '.tmp')
        with open(tmp, 'w') as f:
            json.dump(self._index, f)
        os.replace(tmp, os.path.join(self.dir, _INDEX_NAME))
        self._index_dirty = False

    # direct keyed entries — the whole-program pass addresses its result by
    # an aggregate digest rather than a single file's stamp

    def lookup_key(self, key):
        try:
            with open(os.path.join(self.dir, key + '.json')) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return None
        self.hits += 1
        return [_finding_from_dict(d) for d in payload]

    def store_key(self, key, findings):
        self.misses += 1
        tmp = os.path.join(self.dir, key + '.json.tmp')
        with open(tmp, 'w') as f:
            json.dump([fi.to_dict() for fi in findings], f)
        os.replace(tmp, os.path.join(self.dir, key + '.json'))


# -- the incremental run ----------------------------------------------------

def program_pass_key(scoped_entries):
    """Aggregate content key of the whole-program pass: the analysis package
    fingerprint plus every in-scope file's relpath and bytes, in path order.
    Editing any scoped file — or any checker — is a new key; editing a file
    OUTSIDE the program scope leaves the entry warm."""
    h = hashlib.sha256()
    h.update(b'program-pass:')
    h.update(analysis_fingerprint().encode())
    for abspath, relpath in sorted(scoped_entries, key=lambda e: e[1]):
        h.update(relpath.replace(os.sep, '/').encode())
        try:
            with open(abspath, 'rb') as f:
                h.update(f.read())
        except OSError:
            h.update(b'<unreadable>')
    return h.hexdigest()


def run_analysis_incremental(file_entries, cache=None, baseline=None,
                             select=None, ignore=None, keep_suppressed=False,
                             program_entries=None):
    """:func:`analysis.run_analysis` semantics over an explicit
    ``[(abspath, relpath)]`` listing, optionally through a
    :class:`ResultCache`.

    Per-file checkers are strictly per-file (cross-file inputs — the sibling
    native sources — are part of the cache key), so per-file caching is
    exact, not approximate. Whole-program checkers (the PT13xx race lints)
    run once over ``program_entries`` (default: ``file_entries``) and cache
    their result under :func:`program_pass_key` — a ``--changed`` run must
    pass the FULL listing here, because cross-module properties cannot be
    derived from the changed subset alone."""
    from petastorm_tpu_torch.analysis import ALL_CHECKERS
    checkers = [cls() for cls in ALL_CHECKERS]
    per_file = [c for c in checkers if not c.program_level]
    program = [c for c in checkers if c.program_level]
    findings = []
    for abspath, relpath in file_entries:
        cached = cache.lookup(abspath, relpath) if cache is not None else None
        if cached is None:
            src = SourceFile.load(abspath, relpath)
            cached = run_checkers(per_file, [src], keep_suppressed=True)
            if cache is not None:
                cache.store(abspath, relpath, cached)
        findings.extend(cached)
    if program:
        scoped = [(a, r) for a, r in (program_entries if program_entries
                                      is not None else file_entries)
                  if any(c.matches_path(r.replace(os.sep, '/'))
                         for c in program)]
        prog_findings = None
        key = program_pass_key(scoped) if cache is not None else None
        if cache is not None:
            prog_findings = cache.lookup_key(key)
        if prog_findings is None:
            sources = [SourceFile.load(a, r) for a, r in scoped]
            prog_findings = [f for f in run_checkers(program, sources,
                                                     keep_suppressed=True)
                             if f.code != 'PT000']   # PT000 is the per-file pass's
            if cache is not None:
                cache.store_key(key, prog_findings)
        findings.extend(prog_findings)
    if cache is not None:
        cache.flush_index()
    # the stored results are unfiltered; re-apply the view filters the same
    # way run_analysis/run_checkers do
    open_findings = sorted(f for f in findings if f.status == 'open')
    suppressed = [f for f in findings if f.status != 'open']
    if baseline is not None:
        open_findings, absorbed = baseline.split(open_findings)
        suppressed = suppressed + absorbed
    findings = sorted(open_findings + suppressed) if keep_suppressed \
        else open_findings
    if select is not None:
        prefixes = tuple(select)
        findings = [f for f in findings if f.code.startswith(prefixes)]
    if ignore is not None and tuple(ignore):
        prefixes = tuple(ignore)
        findings = [f for f in findings if not f.code.startswith(prefixes)]
    return findings


__all__ = ['ResultCache', 'analysis_fingerprint', 'changed_file_entries',
           'file_key', 'iter_file_entries', 'program_pass_key',
           'run_analysis_incremental']
