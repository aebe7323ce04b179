"""What the store kinds (``benchmark/stores/<kind>.py``) share: the corpus
made in parallel, and reading stored rows by their row id with pyarrow
alone (the reference's side reads the files, not the program)."""

from __future__ import annotations

import glob
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import pyarrow.parquet as pq

from benchmark import corpus


def host_cores():
    return len(os.sched_getaffinity(0))


def parallel_map(fn, items):
    """``[fn(i) for i in items]`` on a thread per host core (numpy releases
    the interpreter lock), in order."""
    with ThreadPoolExecutor(max(1, host_cores())) as pool:
        return list(pool.map(fn, items))


def process_map(fn, items):
    """``[fn(i) for i in items]`` on a spawned process per host core, in
    order: a store's build, which is Python and numpy throughout."""
    items = list(items)
    workers = max(1, min(host_cores(), len(items)))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context('spawn')) as pool:
        return list(pool.map(fn, items, chunksize=max(1, len(items) // (4 * workers))))


def images(indices, sides):
    """The corpus images ``indices`` at ``sides``."""
    return parallel_map(lambda i: corpus.source_image(i, sides), indices)


def parquet_files(path):
    return sorted(glob.glob(os.path.join(path, '**', '*.parquet'), recursive=True))


def read_rows(path, row_ids, columns):
    """``{column: [value per row id]}`` of the stored rows ``row_ids``,
    found by the ``row_id`` column; only the row groups that hold them are
    read."""
    wanted = {int(r) for r in row_ids}
    found = {}
    for name in parquet_files(path):
        f = pq.ParquetFile(name)
        for rg in range(f.num_row_groups):
            ids = f.read_row_group(rg, columns=['row_id']).column('row_id').to_numpy()
            hits = [k for k, r in enumerate(ids) if int(r) in wanted]
            if not hits:
                continue
            table = f.read_row_group(rg, columns=columns)
            for k in hits:
                found[int(ids[k])] = {c: table.column(c)[k].as_py() for c in columns}
    missing = wanted - set(found)
    if missing:
        raise KeyError('rows {} are not in the store'.format(sorted(missing)[:8]))
    return {c: [found[int(r)][c] for r in row_ids] for c in columns}


def stack(images_list):
    return np.stack(images_list) if images_list else np.zeros((0,), np.uint8)
