"""Spawn a world of ranks on this host and collect what each returns.

What ``torchrun`` does for a script, for a function: ``spawn(fn, n, args)``
starts ``n`` processes (the ``spawn`` start method, so each re-imports
``fn``'s module: keep it in a module that imports neither the caller's
test nor JAX), joins them into one ``torch.distributed`` world through a
``file://`` store in a fresh temporary directory (no TCP port to race for),
calls ``fn(rank, n, *args)`` in each and returns the ``n`` results in rank
order. ``work_dir`` puts that directory (the store and the ranks' result
files) under a directory of the caller's, a test's ``tmp_path``. An
exception in any rank ends the others and is raised here with the rank's
traceback; a world that does not finish within ``timeout_s`` is killed.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

#: a collective that waits longer than this fails instead of hanging
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def _rank_main(rank, world, backend, work_dir, fn, args, threads):
    if backend == 'nccl':
        # one card per rank; a graphed step under DDP needs the variable
        # before the group exists
        os.environ['LOCAL_RANK'] = str(rank)
        os.environ.setdefault('TORCH_NCCL_ASYNC_ERROR_HANDLING', '0')
        torch.cuda.set_device(rank)
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method='file://' + os.path.join(work_dir, 'store'),
                            rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        result = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work_dir, 'rank{}.pkl'.format(rank)), 'wb') as f:
        pickle.dump(result, f)


def spawn(fn, nprocs, args=(), backend='gloo', timeout_s=600, threads=None, work_dir=None):
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` spawned ranks of one
    world over ``backend`` (``'gloo'``, or ``'nccl'`` with one card per
    rank); return their results in rank order. ``threads`` sets each rank's
    intra-op thread count; the world's store lives in a fresh directory
    under ``work_dir`` (default: the system's temporary directory)."""
    if backend == 'nccl' and torch.cuda.device_count() < nprocs:
        raise RuntimeError('{} NCCL ranks need {} CUDA devices; this host has {}'.format(
            nprocs, nprocs, torch.cuda.device_count()))
    work_dir = tempfile.mkdtemp(prefix='pstpu_world_', dir=work_dir)
    try:
        context = torch.multiprocessing.start_processes(
            _rank_main, args=(nprocs, backend, work_dir, fn, tuple(args), threads),
            nprocs=nprocs, join=False, start_method='spawn')
        deadline = time.monotonic() + timeout_s
        while not context.join(timeout=1.0):
            if time.monotonic() > deadline:
                for process in context.processes:
                    process.kill()
                for process in context.processes:
                    process.join()
                raise TimeoutError('{} ranks of {} did not finish within {} s'.format(
                    nprocs, getattr(fn, '__name__', fn), timeout_s))
        results = []
        for rank in range(nprocs):
            with open(os.path.join(work_dir, 'rank{}.pkl'.format(rank)), 'rb') as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
