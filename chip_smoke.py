"""chip_smoke.py: the quickest proof that petastorm_tpu_torch runs on an NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card, its power limit, and the TF32 settings used;
2. kernel checks: every hand-written kernel of the main path against its plain
   PyTorch version on the card (shapes, types and tolerances below), and the
   times of both and of the one PyTorch call that computes the same function
   (CUDA events, median of 25 runs);
3. stores: a raw uint8 store, an ImageNet-shaped PNG store, a fixed-shape
   PNG store of the raw store's images and, where the host can encode and
   decode JPEG, a JPEG store, written by the port's ``materialize_dataset``
   from a seed; and the plain store: the raw store's images as PNG bytes in
   a ``binary`` column with an ``int64`` label, written by
   ``pyarrow.parquet.write_table`` with no petastorm metadata;
4. decode checks: what the host offers for image decode (OpenCV, the image
   libraries' headers and shared objects) and what the port's native decoder
   built with; the route that decodes and the route that resizes each
   format; the native decoder against the images as written (PNG: exact) on
   256 store images and on PNGs written here with every row filter; each
   resize route against the plain route (the numpy resamplers' weights,
   applied in float64) within 1 LSB; the host's decode+resize rate on one
   core and on a pool of one thread per core. The host probe also reports
   pyarrow, its headers, pyzmq, and the native Parquet reader's build time
   and ABI: a reader that did not build fails the run;
5. read checks: every row group of the raw store read by the row worker
   through the native reader (page-scan views) equals the same row group
   through ``pq.ParquetFile`` and the codecs; every row group of the
   fixed-shape PNG store read through the fused native call equals the
   images as written and the route with the fused read switched off
   (``PSTPU_DISABLE_FUSED``); each route counted in ``native.read_routes``
   as named; the host's read rate of each pair on one core and on a pool of
   one thread per core;
6. filter checks: every row group of the fixed-shape PNG store read by the
   row worker through the fused predicate call (``in_set``, ``in_range``,
   ``in_negate``, ``in_reduce`` on the label) equals the rows the predicate
   keeps as written and the same read with the fused read switched off (the
   Python pushdown), with every row group through the fused predicate call,
   the rows it selected and the pages it skipped by their statistics
   counted, and no fallback; a row-group index of the PNG store's synsets
   built over a copy of it (its seconds), whose selector picks exactly the
   row groups of the synsets it names; ``shuffle_row_drop_partitions=2``
   over the PNG store delivers every row once in one epoch; the host's
   filtered read rate on one core against the unfiltered fused read;
7. pool checks: the process pool's shared-memory ring (built from
   ``native/shm_ring.cpp``) in one process: ``write2``, ``writev``,
   ``reserve``/``commit``/``abort``, ``try_read_zero_copy``/``release``;
   a ``ProcessPool`` of one spawned worker per core on the shm transport
   over the raw store (copy mode and ``zero_copy=True``, 24 epochs) and
   the fixed-shape PNG store (copy mode, two epochs): every block equals the
   thread pool's block of the same row group, exactly; a worker SIGKILLed
   mid-item: every row group still delivered exactly once,
   ``worker_restarts >= 1``, and no worker imported ``torch``; for each
   pool its start time, each epoch's seconds and its rows/s after the
   warm-up epochs (half of the raw store's, one of the PNG store's). The ring
   size is ``ProcessPool``'s 64 MiB unless ``/dev/shm`` cannot hold one per
   worker: then what fits, if that still holds what a consumer can pin
   (:func:`ring_bytes_for`), else the run fails naming the sizes;
8. paths, each a full-width ResNet-50 bf16 train step (1000 classes, batch 64,
   160 px, SGD 0.1 momentum 0.9, the step's flip mask and
   ``normalize_images`` inside it) fed by ``make_reader(output='columnar')``
   (thread pool, one worker per core) -> ``TorchDataLoader`` (shuffle 512,
   seed 7) -> ``prefetch_to_device(size=2)``, 3 warm-up and 10 measured
   steps through ``pipeline_duty_cycle``, a fresh model from one seed each.
   Every path runs twice in the call: with the eager step and with the
   graphed one (``make_train_step(graphed=True)``: two eager warm-up steps,
   then the whole step captured in one CUDA graph and replayed), one line
   each; then a ``graph_check`` line: a fresh eager step from the seed on
   the graphed run's first four staged batches gives its losses, the first
   within 1e-3 (both eager forwards of one model), the capture's and the
   replay's within 1e-2 (bf16 convolutions need not be bit-reproducible):

   - ``raw``: the raw store, no decode;
   - ``raw_elastic``: ``raw``'s trainer as host ``h0`` of an elastic pod
     (``make_reader(elastic=ElasticConfig(host_id='h0', lease_s=1.0,
     poll_s=0.05))``, ``docs/parallelism.md:66-130``, ``bench_pod.py
     --chaos``) whose other hosts are ``petastorm_tpu_torch.elastic.
     _hostproc`` processes reading the labels at 2 ms a row: ``h1`` and
     ``h2`` from the start; once the measured steps begin,
     ``drive_host_churn`` SIGKILLs ``h1`` after 4 more commits and starts
     ``h3`` (the last measured step waits for it); the survivors are stopped after the trainer (SIGTERM: they
     leave the pod). A fresh pod for each step kind. Checks: the kill fell
     inside the measured steps; ``h1`` died of SIGKILL, the others exited 0;
     at least 3 generations; no ``elastic_ventilator_errors``; every commit
     at its item's rank in ``global_order(16, 7, epoch)``, no item committed
     twice, every closed epoch (the kill's included) one commit per done
     marker; the row groups ``h1`` held in flight at the kill committed by
     other hosts; ``h3`` committed row groups of its own before the
     survivors stopped; no lease left but ``h1``'s (and, when the kill
     landed inside a renewal, ``h1``'s staged ``h1.lease.tmp.<pid>``). An
     ``elastic`` line per run
     (commits at the kill, generations, handoffs, each host's share of the
     commits, the seconds from the kill until the last of ``h1``'s claims
     was committed) and an ``elastic_vs_raw`` line;
   - ``raw_mesh``: ``raw`` through the example's mesh flow
     (``jax_resnet_example.py:81-102``): ``make_mesh(('data',))`` (a world
     of one over NCCL), ``shard_train_state``, the reader on
     ``reader_shard_for_process(mesh)``, the batches staged onto
     ``data_sharding(mesh)``; after each run a ``mesh_vs_plain`` line: a
     fresh unsharded state with the same kind of step on the run's first
     four staged batches gives its losses to the last bit (no DDP and no
     collective at a world of one);
   - ``png``: the PNG store with ``TransformSpec(image_resize=160x160)`` and a
     batched label transform (crc32 of the synset id);
   - ``png_cached``: the same with ``cache_type='local-disk'``, after one
     epoch that fills the cache; its run must read every row group from it;
   - ``jpeg``: a JPEG store of 320-560 px photos, where the probe allows it
     (else one line says why it is skipped);
   - ``png_fixed``: the fixed-shape PNG store (``BASELINE.json`` config 3's
     image column), no resize: the fused native read decodes every image;
   - ``png_served``: the ``png`` path read through the shared reader daemon
     (``make_reader(serve=<work dir>/svc)``; ``python -m
     petastorm_tpu_torch.serve``, a thread fleet of one worker per core, its
     broadcast ring sized from ``/dev/shm``'s free bytes as
     :func:`ring_bytes_for` does), while a second tenant, a host process
     that imports no torch, attached first and drains the same stream: both
     tenants get the same block for every dispatch both received and, each
     epoch, every row group once; the daemon published no more batches than
     it dispatched row groups; every 16-row batch (1.2 MB) came by blob; no
     read, decode or resize in the trainer; the labels are the store's; no
     GPU library in the daemon. A ``serve_path`` line, then a
     ``served_vs_png`` line beside ``png``'s numbers of the same call with
     the second tenant's rows/s; then ``serve_checks``: the fixed-shape PNG
     store through a daemon by the fused blob route (``SERVE_COLS``), every
     block equal to the private fused read's; on a 64 KiB ring a tenant that
     never reads evicted (``ConsumerEvictedError``) while the other reads
     all 480 label batches; a SIGKILLed daemon raising
     ``ServeDaemonDiedError``; each daemon exiting on shutdown with no
     ``/dev/shm`` segment left (a SIGKILLed one leaves its ring and blob
     dir, which the phase removes and names).

   The kernels' launch counts and the image route counts are set to 0 just
   before each path and read just after it, and the read routes are counted
   over the path's run: a kernel of the path that was not launched, an image
   decoded or resized by a route other than the one the decode checks named,
   or a column read by a route other than the path's (``raw``,
   ``raw_elastic``: page scan only; ``png``/``jpeg``: images to the codec with reason ``image-hints``,
   strings with reason ``codec``; ``png_cached``: no read; ``png_fixed``:
   fused only; ``png_served`` no read) fails the run. The first staged batch of each path is checked
   against the store's rows, the losses for being finite and starting near
   log(1000). Two more paths read through the process pool (one spawned
   worker per core, shm transport):

   - ``raw_process``: the raw store with ``zero_copy=True``, no transform and
     no cache: every row group decoded by the fused native call straight into
     the ring slot the consumer maps (``fused_inplace_batches_total`` equals
     ``fused_batches_total``, two columns each, no page scan, no Arrow), every
     publish in place; once the reader stopped no zero-copy borrow is live;
   - ``png_process``: the ``png`` path through the process pool in copy mode:
     a decoded 16-row block is above the 1 MiB blob threshold, so every
     publish rides the ``/dev/shm`` blob channel.

   Each fails on another transport than shm, a restart, a quarantined item or
   a ``/dev/shm/pstpu_*`` entry of this process left behind. Two more read
   a filtered store through the thread pool:

   - ``png_fixed_pred``: the fixed-shape PNG store with
     ``predicate=in_set(range(100), 'label')`` (124 of 1024 rows an epoch,
     from 9 of 64 row groups): every row group through the fused predicate
     call, pages skipped by their statistics, every delivered label below
     100;
   - ``png_select``: the ``png`` path over the indexed copy of the PNG store
     with ``rowgroup_selector=SingleIndexSelector('noun_id_idx', <the first
     16 of 32 synsets>)`` and ``shuffle_row_drop_partitions=2`` (512 rows an
     epoch, read as 64 half row groups through Arrow), every delivered label
     that of a selected synset.

   One more reads the plain store through ``make_batch_reader``:

   - ``plain_batch``: ``make_batch_reader(batch_size=64)`` (the reader
     rebatches its 16-row row groups) with a batched ``TransformSpec`` that
     decodes the ``image`` column's PNG bytes with the port's native decoder
     (``edit_fields``: uint8 160x160x3): every block the loader received has
     64 rows, the schema was inferred (``image``, ``label``), the ``label``
     column came from the fused read and the ``binary`` image column through
     Arrow (reason ``codec``), and the first staged batch is rows of the
     store;
9. ``plain_resume``, once with each step: the ``plain_batch`` reader and
   loader on the dummy pool with the loader's ``to_device`` (no prefetch
   queue), so the run is deterministic: 13 steps uninterrupted; then 5 from
   the seed, the model's, the optimizer's and the loader's states through
   ``torch.save`` to bytes, the reader stopped and joined, and 8 more steps
   from a new model, optimizer, reader and loader built from those states.
   Each resumed batch must hold exactly the rows (images and labels) of the
   uninterrupted batch at that step; the loader's state keeps rows, not the
   shuffling buffer's blocks, so their order within a batch may differ (the
   JAX loader's resume does the same), and the step trains on them in the
   uninterrupted order; the losses agree within 1e-2; the line gives the
   pickled loader state's size and how many batches kept their order. The
   eager and the graphed run's first losses agree within 1e-3;
10. ``resume_checks``: on the thread pool over one epoch of the plain store,
   checkpointed at batch 5 and resumed, the rows delivered before and after
   are the epoch's 1024 rows, each once; version-2 states of shards 0 and 1
   of 2, merged with ``merge_resume_states`` and restored on one reader,
   read every unfinished row group once; a state resumed by a reader over
   another item list is refused with the reference's error; a
   ``batch_size=64, drop_last=True`` state of shard 0 of 3 reads the rows
   the drop left undelivered again after the resume;
11. ``telemetry_checks``: ``raw`` with the graphed step at each telemetry
   level (``off``, ``counters``, ``spans``) and ``raw_process`` at ``off``
   and ``counters`` in one call, the cost of telemetry beside ``off`` (on
   the process pool it includes each item's registry snapshot in its
   metrics frame); then ``png_fixed`` at ``spans``: the Chrome
   traces of both ``spans`` runs under ``.torch_build/``, the span names
   ``ventilate``, ``read``, ``fused_decode``, ``pool_wait``,
   ``shuffle.add_block``, ``shuffle.emit``, ``collate`` and ``infeed``
   between them (``png_fixed`` fuses both its columns, so its own spans have
   no ``read``/``decode``), a span tree linking ``ventilate`` to ``infeed``
   in each, the ring within its capacity, and the slowest batch's stage
   breakdown. Every path line (all at ``counters`` unless named) carries the
   stall report of the loader's diagnostics (``stall``), checked against
   the path's routes, and every stage timer's seconds and count;
12. ``autotune_checks``: ``raw_process`` and then ``raw`` (thread pool)
   with the graphed step under the autotuner (``interval_s=0.5``, workers
   1 to the core count, starting at 2) for 3 + 60 steps: every decision,
   the worker count over time, each epoch's rows at most once and every
   complete epoch's rows exactly once across the resizes, no restart, no
   ``/dev/shm`` entry left;
13. ``collate_checks``: ``bench.py``'s token store (4096 rows of
   ``min(zipf(1.6), 256)`` tokens, 256 per row group) through the padded
   loader, the bucketed loader and ``PackedSequenceLoader``, each batch
   staged to the card and equal to its host collation, every real token
   delivered once, bucketing wasting less padding, two packed runs
   bit-exact, and each consumer's real tokens/s;
14. ``ngram_checks``: ``examples/sequence``'s telemetry store (16384 rows
   of AR(1) features, 64 wide, ``sensor_id = i % 8``, 256 rows per row
   group, seed 0; a ``store`` line) in windows of 8 consecutive timestamps:
   the columnar NGram assembly's windows/s on one core over the decoded row
   groups, one epoch of windows through the thread pool and through the
   process pool (one worker per core, shm) in windows/s, and the process
   pool's windows equal to the thread pool's, every field, all 15936 of
   them;
15. the sequence paths, ``jax_sequence_example.py:39-80``'s flow on a
   ``('data', 'seq')`` mesh of a world of one over NCCL:
   ``make_reader(output='columnar', ngram=..., shuffle_row_groups=True,
   seed=0, num_epochs=None)`` -> ``TorchDataLoader`` (batch 16) ->
   ``prefetch_to_device`` onto the mesh's data sharding ->
   ``stack_ngram_time_axis`` on the card -> the example's
   ``SequenceTransformer`` (d_model 64, 4 heads, 2 layers, float32, labels
   ``sensor_id[:, 0] % 8``) sharded onto the mesh, the plain step, 3 warm-up
   and 10 measured steps, eager and graphed, one line each: ``seq_ring``
   (ring attention) and ``seq_ulysses`` (Ulysses attention). Each checks
   its first staged batch against the store (consecutive timestamps, the
   features as written), its losses (finite, the first near log(8)), its
   read routes (all three columns through the fused read) and stall stages;
   then a ``graph_check`` (a fresh eager step on the graphed run's first
   four batches: within 1e-5, and whether equal to the last bit), a
   ``profile`` line per step kind (the device's idle share on a staged
   batch) and a ``model_check`` (the trained model against a float32 CPU
   copy, 1e-4);
16. ``seq_checks``: four spawned ranks on the one card over gloo with CUDA
   tensors, a ``(2, 2)`` ``('data', 'seq')`` mesh at ``bench_pod.py``'s
   sequence shape (windows of 4, 64 features, batch 16, d_model 64, 2
   layers): ring and Ulysses, causal and not, three steps each, every rank
   reading its data coordinate's shard through a 2-worker thread pool and
   staging its ``[B/2, T/2, F]`` slice onto the sequence sharding; against
   one process with plain attention on the same global batches: the losses
   and every parameter within 1e-4, and the ranks of each seq group on the
   same labels. Gloo takes the ring's and Ulysses' exchanges through host
   memory (NCCL refuses two ranks on one card);
16a. ``seq_moe``: the flow of 15 with ``MoESequenceTransformer`` at its own
   widths (d_model 64, 4 heads, 2 layers, capacity factor 1.25, d_hidden
   256) and 8 experts on a ``('data', 'expert')`` mesh of a world of one
   over NCCL (N = 128 tokens, C = 20 slots an expert), stepped on
   ``moe_loss`` (cross entropy + 0.01 aux), eager and graphed; each line
   adds every step's aux loss, and a ``routing`` line per step kind gives
   each layer's expert loads and dropped-token fraction on the last batch,
   computed outside the step; then ``graph_check``, ``profile`` and
   ``model_check`` (logits and aux loss) as for 15;
16b. ``moe_checks``: four spawned ranks on the one card over gloo with CUDA
   tensors on ``(2, 2)`` and ``(1, 4)`` ``('data', 'expert')`` meshes, the
   ``seq_moe`` model with its experts sharded over the expert group, each
   rank reading its data coordinate's shard (a 2-worker thread pool),
   global batch 16, three steps; against one process stepping the global
   batches: the losses, aux losses and every parameter (experts gathered)
   within 1e-4, the ranks of each expert group on the same rows;
16c. ``pp_checks``: four spawned ranks over gloo on a ``('stage',)`` mesh
   of 4: the dry run's stage ``gelu(act @ w + b)`` at width 64, stacked
   parameters from the seed (the dry run's scale 0.3 at width 8, held
   variance-preserving: 0.3 x sqrt(8/64)), 64 rows of the store staged onto
   every stage,
   8 microbatches; the output against the stages run one after another
   (2e-5), the gradients of ``sum(y**2)`` (rtol 2e-4, atol 2e-5), each
   rank's seconds per forward and per forward + backward, the bubble
   fraction 3/11; then the same draws at the dry run's scale 0.3, where the
   gradients grow past those tolerances' reach, against the stages run in
   float64: the pipeline's error within twice the float32 sequential run's
   own (``dry_run_scale``); a ``moe_pp_phases`` line gives 16a-16c's
   seconds;
17. ``flight_checks``: a child process runs ``raw_process`` (eager, 3 + 6
   steps) with ``PSTPU_FLIGHT_DIR`` under ``.torch_build/``: its flight file
   and one per worker exist while it runs, and after its exit
   ``postmortem_report`` names every process, all exited cleanly, with the
   loader's closing stall record;
18. ``mesh_checks``: four spawned ranks on the one card over gloo with CUDA
   tensors (NCCL refuses two ranks on one card), a ``(2, 2)``
   ``('data', 'model')`` mesh and the dry run's configuration (resnet18, 64
   filters, 16 classes, 32x32 uint8 images of a 64-row store, float32, TF32
   off, 2 rows per data shard, flip and normalize in the step; PyTorch's own
   convolutions, not cuDNN's, on both sides: ``MESH_CUDNN``): each rank
   reads its data coordinate's shard through a 2-worker thread pool and
   ``prefetch_to_device`` onto the data sharding, and takes three sharded
   steps (synchronised batch norm, the column-parallel head, DDP over the
   data group). This process steps one model from the same seed on the
   global batches: the losses, every parameter (the head gathered) and
   every batch statistic of every rank within 1e-4 after steps 1 and 3,
   the head's gradient after step 1 its slice on every rank, and the two
   ranks of each model group on identical batches; the spawn seconds and
   each rank's seconds per step;
19. ``entry_checks``: ``petastorm_tpu_torch.entry.entry()``'s ResNet-50 bf16
   forward on the card (shape, dtype, finite values) and
   ``dryrun_multichip(1)`` over NCCL (all five legs: dp/tp, process pool,
   sp, ep and pp, none unported; its ``ep_loss`` and ``pp_err``);
20. profile: three more steps of the raw path under ``torch.profiler``, with
   the eager and with the graphed step, each on its own state: the device's
   busy time per step by kernel and its idle share;
21. model check: the trained model on the card (bf16) against a float32 copy
   of it on the CPU, on four images of the store;
22. a ``kernels`` line (per kernel: route, source, the TPU kernel it replaces,
   launches over all paths, both steps, where a graph replay counts the
   launches it captured, and the spawned ranks' of ``mesh_checks`` and
   ``entry_checks``; the sequence, MoE and pipeline paths normalize
   nothing), max error, its time, the plain version's time,
   the least time the card could take and what bounds it, and the time of
   the one PyTorch call that computes the same function,
   ``torch.addcmul``), the card's name and power limit as ``nvidia-smi``
   gives them, and last ``{"ok": true, "device": {...}}``.

No failure is caught: any exception ends the run with a non-zero exit code and
no result line. Without CUDA the run fails at once. The native libraries
(the reader, the image decoder and the ring, each built on a thread of its
own while Triton compiles), the Triton cache, the
stores and the disk cache live under ``.torch_build/`` in the checkout.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(ROOT, '.torch_build')

IMAGE_SIZE = 160
NUM_CLASSES = 1000
BATCH = 64
ROWS = 1024
ROWS_PER_ROW_GROUP = 64
# the image stores: bench_duty.py's png and jpeg variants
IMAGES_PER_SYNSET = 32
IMAGE_ROWS_PER_ROW_GROUP = 16
PNG_DIMS = (64, 160)
JPEG_DIMS = (320, 560)
# store images the decode checks hold against the images as written
CHECK_IMAGES = 256
# where the paths put their batches
DEVICE_TYPE = 'cuda'
WARMUP_STEPS = 3
STEPS = 10
SEED = 7
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# the loader's shuffle buffer on every path
SHUFFLE_CAPACITY = 512
# ProcessPool's default ring size, per worker
RING_BYTES = 64 << 20
# epochs of the raw store each pool reads in the pool checks, and the first
# of them left out of the rate: a worker's first lap around its ring and its
# first reads of the store fault in pages of its mappings, which costs more
# than the copies themselves where page faults are dear (a 64 MiB ring holds
# 13 raw row groups; one worker per core reads 2 of an epoch's 16)
POOL_EPOCHS = 24
POOL_WARM_EPOCHS = 12

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

    # the one PyTorch call that computes the function: x * inv_std + shift,
    # with shift = -mean * inv_std, uint8 in, float32 math, bf16 out
    shift = -mean * inv_std
    library_out = torch.empty(shape, dtype=torch.bfloat16, device=dev)

    def library(x):
        return torch.addcmul(shift, x, inv_std, out=library_out)

    library_err, library_ok = 0.0, True
    for x in inputs[:4]:
        ref = plain(x).float()
        diff = (library(x).float() - ref).abs()
        library_err = max(library_err, float(diff.max()))
        library_ok = library_ok and bool((diff <= 2.0 ** -7 * ref.abs() + 1e-6).all())
    # in turns: plain, kernel, library, library, kernel, plain
    plain_ms = [cuda_ms(torch, plain, inputs)]
    kernel_ms = [cuda_ms(torch, kernel, inputs)]
    library_ms = [cuda_ms(torch, library, inputs), cuda_ms(torch, library, inputs)]
    kernel_ms.append(cuda_ms(torch, kernel, inputs))
    plain_ms.append(cuda_ms(torch, plain, inputs))
    # back to back without holding the device: the rate at which the host
    # can launch the wrapper, which is what a caller's loop sees
    host_rate_ms = cuda_ms(torch, kernel, inputs, hold_device=False)
    bound_ms, bound_by = normalize_bound_ms(shape, torch.uint8, torch.bfloat16, torch)
    library_check = {'call': 'torch.addcmul(shift_c, x_uint8, inv_std_c, out=out_bf16)',
                     'max_abs_err': library_err, 'tolerance': '1 bf16 ulp', 'ok': library_ok,
                     'ms_runs': library_ms}
    if not library_ok:
        library_check['why_not_counted'] = ('the call does not compute the function within 1 '
                                            'bf16 ulp of the plain version on these inputs')
    emit({'phase': 'kernel_checks', 'kernel': 'normalize', 'checks': checks,
          'timing_shape': list(shape), 'ms_runs': kernel_ms, 'plain_ms_runs': plain_ms,
          'library': library_check, 'launch_rate_ms': host_rate_ms,
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
             'library_ms': statistics.median(library_ms) if library_ok else None}]


def _photo(rng, h, w):
    """A photo-like image: smooth gradients and mild noise, made from ``rng``
    (pure noise would make PNG pick no row filters and decode unrealistically
    fast)."""
    yy = np.linspace(0, 4 * np.pi, h)[:, None, None]
    xx = np.linspace(0, 4 * np.pi, w)[None, :, None]
    phase = rng.uniform(0, 2 * np.pi, 3)[None, None, :]
    base = np.sin(xx + phase) * 70 + np.cos(yy + phase * 0.5) * 60 + 128
    return np.clip(base + rng.normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _image(index):
    """The raw store's image ``index``, made from a seed, so a batch can be
    checked against the rows it came from (kept: the fixed-shape PNG store
    and the checks use the same images; 79 MB for all)."""
    return _photo(np.random.default_rng([SEED, index]), IMAGE_SIZE, IMAGE_SIZE)


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


# -- the image stores and their checks -----------------------------------------

def _png_chunk(kind, data):
    return (len(data).to_bytes(4, 'big') + kind + data
            + zlib.crc32(kind + data).to_bytes(4, 'big'))


def png_bytes(img):
    """A non-interlaced 8- or 16-bit gray or RGB PNG of ``img``, written with
    numpy and zlib, its rows filtered None, Sub, Up, Average, Paeth in turn,
    so that a decode runs every unfilter of the format."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = img.dtype.itemsize * 8
    raw = np.ascontiguousarray(img, dtype='>u2' if depth == 16 else np.uint8)
    raw = raw.reshape(h, -1).view(np.uint8).astype(np.int32)
    bpp = channels * depth // 8
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    # Paeth predicts from the original bytes only, so it vectorises
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    predictors = [np.zeros_like(raw), left, up, (left + up) // 2, paeth]
    rows = [bytes([y % 5]) + ((raw[y] - predictors[y % 5][y]) % 256).astype(np.uint8).tobytes()
            for y in range(h)]
    ihdr = (w.to_bytes(4, 'big') + h.to_bytes(4, 'big')
            + bytes([depth, 0 if channels == 1 else 2, 0, 0, 0]))
    return (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', ihdr)
            + _png_chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + _png_chunk(b'IEND', b''))


def _image_rows(dims):
    """ImageNet-shaped rows: ``IMAGES_PER_SYNSET`` images per synset, each of
    random height and width in ``dims``, in the order
    ``examples/imagenet/generate_petastorm_imagenet.py`` makes them."""
    rng = np.random.default_rng(SEED)
    for s in range(ROWS // IMAGES_PER_SYNSET):
        noun_id = 'n{:08d}'.format(s)
        for _ in range(IMAGES_PER_SYNSET):
            h, w = int(rng.integers(*dims)), int(rng.integers(*dims))
            yield {'noun_id': noun_id, 'text': 'synthetic synset {}'.format(s),
                   'image': _photo(rng, h, w)}


def _image_codec(image_format, encoder):
    """The ``compressed_image`` codec the stores are written with;
    ``encoder='numpy'`` (PNG on a host without OpenCV) writes the cells with
    :func:`png_bytes` under the same codec id."""
    from petastorm_tpu_torch.codecs import CompressedImageCodec

    class NumpyPngCodec(CompressedImageCodec):
        def encode(self, field, value):
            return png_bytes(value)

    return (NumpyPngCodec if encoder == 'numpy' else CompressedImageCodec)(image_format)


def build_image_store(url, image_format, dims, encoder):
    """An ImagenetSchema-shaped store (``noun_id``, ``text``, ``image``),
    ``IMAGE_ROWS_PER_ROW_GROUP`` rows per row group. Returns the PNG store's
    images as written."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    codec = _image_codec(image_format, encoder)
    schema = Unischema('ImagenetSchema', [
        UnischemaField('noun_id', np.str_, (), ScalarCodec(), False),
        UnischemaField('text', np.str_, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (None, None, 3), codec, False)])
    written = []
    with materialize_dataset(url, schema, rows_per_row_group=IMAGE_ROWS_PER_ROW_GROUP) as writer:
        for row in _image_rows(dims):
            writer.write(row)
            if image_format == 'png':
                written.append(row['image'])
    return written


def build_png_fixed_store(url, encoder):
    """The pre-resized PNG store, shaped as ``BASELINE.json`` config 3's
    image column (HelloWorldSchema's fixed-shape ``CompressedImageCodec('png')``,
    ``examples/hello_world/petastorm_dataset/generate_petastorm_dataset.py:18-20``):
    the raw store's images (:func:`_image`) PNG-encoded at their full
    160x160x3 shape and an int64 label, the writer's default snappy,
    ``IMAGE_ROWS_PER_ROW_GROUP`` rows per row group. A fully specified shape
    and no resize is what lets the fused native read decode the images."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('PngFixed', [
        UnischemaField('image', np.uint8, (IMAGE_SIZE, IMAGE_SIZE, 3),
                       _image_codec('png', encoder), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])
    with materialize_dataset(url, schema, rows_per_row_group=IMAGE_ROWS_PER_ROW_GROUP) as writer:
        for i in range(ROWS):
            writer.write({'image': _image(i), 'label': np.int64(i % NUM_CLASSES)})


def build_plain_store(url, rows=None, image=None):
    """The plain store (``BASELINE.json`` config 2, a plain ImageNet-style
    Parquet dump as Spark jobs and dataset hubs write them): the raw store's
    images (:func:`_image`, or ``image(i)``) as PNG bytes in a ``binary``
    column ``image`` and an ``int64`` column ``label``, written by
    ``pyarrow.parquet.write_table`` with no petastorm metadata, snappy,
    ``IMAGE_ROWS_PER_ROW_GROUP`` rows per row group."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows = rows or ROWS
    image = image or _image
    path = url[len('file://'):]
    os.makedirs(path, exist_ok=True)
    table = pa.table({'image': pa.array([png_bytes(image(i)) for i in range(rows)], pa.binary()),
                      'label': pa.array(np.arange(rows, dtype=np.int64) % NUM_CLASSES)})
    pq.write_table(table, os.path.join(path, 'part-00000.parquet'),
                   row_group_size=IMAGE_ROWS_PER_ROW_GROUP, compression='snappy')


class DecodePngColumn(object):
    """The plain paths' batched transform: the ``image`` column's PNG bytes
    decoded by the port's native decoder in one call and stacked (module
    level, so it pickles)."""

    def __call__(self, block):
        from petastorm_tpu_torch.native import image_codec

        block['image'] = np.stack(image_codec.decode_images(list(block['image'])))
        return block


def plain_transform(size=None):
    from petastorm_tpu_torch import TransformSpec
    from petastorm_tpu_torch.unischema import UnischemaField

    size = size or IMAGE_SIZE
    return TransformSpec(DecodePngColumn(), edit_fields=[
        UnischemaField('image', np.uint8, (size, size, 3), None, False)])


def label_of(noun_id):
    return zlib.crc32(str(noun_id).encode()) % NUM_CLASSES


class LabelFromNounId(object):
    """The batched label transform of ``examples/imagenet/jax_resnet_example.py``:
    the image arrives resized by the decode worker, the label is crc32 of the
    synset id (module level, so it pickles)."""

    def __call__(self, block):
        labels = np.fromiter((label_of(n) for n in block['noun_id']), dtype=np.int64,
                             count=len(block['noun_id']))
        return {'image': block['image'], 'label': labels}


def image_transform():
    from petastorm_tpu_torch import TransformSpec
    from petastorm_tpu_torch.unischema import UnischemaField

    return TransformSpec(
        LabelFromNounId(),
        edit_fields=[UnischemaField('image', np.uint8, (IMAGE_SIZE, IMAGE_SIZE, 3), None, False),
                     UnischemaField('label', np.int64, (), None, False)],
        removed_fields=['noun_id', 'text'], batched=True,
        image_resize={'image': (IMAGE_SIZE, IMAGE_SIZE)})


def plain_resize(img, out_h, out_w):
    """The plain resize route: the port's numpy resamplers' weights under the
    shared policy, applied one axis at a time in float64 (the numpy route
    itself, ``_resample_numpy``, contracts both axes at once and takes
    seconds per image)."""
    from petastorm_tpu_torch.codecs import _area_weights, _bilinear_weights, _mild_ratio

    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img
    weights = _bilinear_weights if _mild_ratio(h, w, out_h, out_w) else _area_weights
    rows = _contract(weights(h, out_h), img.astype(np.float64))  # [out_h, w, ...]
    out = _contract(weights(w, out_w), rows.swapaxes(0, 1)).swapaxes(0, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _contract(weights, arr):
    """``weights [out, in]`` times ``arr [in, ...]`` over the few taps each
    output row has (a dense product would spend its time on zeros)."""
    nonzero = weights != 0
    first = nonzero.argmax(axis=1)
    last = weights.shape[1] - 1 - nonzero[:, ::-1].argmax(axis=1)
    rows = np.arange(len(weights))
    out = np.zeros((len(weights),) + arr.shape[1:])
    for k in range(int((last - first).max()) + 1):
        idx = np.minimum(first + k, weights.shape[1] - 1)
        tap = np.where(first + k <= last, weights[rows, idx], 0.0).astype(np.float64)
        out += tap.reshape((-1,) + (1,) * (arr.ndim - 1)) * arr[idx]
    return out


def _max_err(a, b):
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _resize_errors(outs, refs):
    return {'max_abs_err': max(_max_err(o, r) for o, r in zip(outs, refs)), 'images': len(outs),
            'differing_values': sum(int((o != r).sum()) for o, r in zip(outs, refs)),
            'values': sum(r.size for r in refs)}


def _host_cpu():
    model = 'unknown'
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    model = line.split(':', 1)[1].strip()
                    break
    except OSError:
        pass
    return {'cpu_model': model, 'cpu_count': os.cpu_count()}


class NativeBuild(threading.Thread):
    """One native library of the port, built by g++ on a thread of its own
    while Triton compiles the kernel; ``seconds`` and ``error`` once joined."""

    def __init__(self, build_fn):
        super().__init__(daemon=True)
        self._build_fn = build_fn
        self.seconds = self.error = None
        self.start()

    def run(self):
        t0 = time.perf_counter()
        try:
            self._build_fn()
        except Exception as e:  # noqa: BLE001 - probe_host reports it, and fails on the reader's
            self.error = repr(e)
        self.seconds = time.perf_counter() - t0


def _dev_shm():
    """``/dev/shm``'s total and free bytes (``os.statvfs``)."""
    st = os.statvfs('/dev/shm')
    return {'total_bytes': st.f_blocks * st.f_frsize, 'free_bytes': st.f_bavail * st.f_frsize}


def probe_host(builds):
    """What the host offers for image decode, Parquet reads and the process
    pool, and what the port's native libraries built with. Decides the routes
    the paths must take; a native Parquet reader or a ring library that did
    not build fails the run (the reader would quietly read through pyarrow,
    the process pool through zmq)."""
    import multiprocessing

    import pyarrow

    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.native import image_codec, shm_ring

    for build in builds.values():
        build.join()
    found = {}
    for module in ('cv2', 'PIL', 'zmq'):
        try:
            found[module] = __import__(module).__version__
        except ImportError:
            found[module] = None
    headers = {h: os.path.exists(os.path.join('/usr/include', h))
               for h in ('jpeglib.h', 'png.h', 'libdeflate.h', 'zlib.h')}
    ldconfig = subprocess.run(['ldconfig', '-p'], capture_output=True, text=True, timeout=60)
    libs = sorted({line.split()[0] for line in ldconfig.stdout.splitlines()
                   if any(k in line for k in ('libjpeg', 'libpng', 'libdeflate', 'libz.'))})
    features = image_codec.features()  # loads the library built above
    reader = {'pyarrow': pyarrow.__version__,
              'arrow_api_h': os.path.exists(os.path.join(pyarrow.get_include(), 'arrow', 'api.h')),
              'build_s': builds['reader'].seconds, 'build_error': builds['reader'].error,
              'available': native.is_available(), 'abi': native.abi_version()}
    if features is None:
        png_decode = 'cv2' if found['cv2'] else None
    else:
        png_decode = 'native'
    if features is not None and features['libjpeg']:
        jpeg_decode = 'native'
    else:
        jpeg_decode = 'cv2' if found['cv2'] else None
    resize = 'cv2' if found['cv2'] else ('native' if features is not None else 'numpy')
    pool = {'ring_build_s': builds['ring'].seconds, 'ring_build_error': builds['ring'].error,
            'ring_available': shm_ring.is_available(), 'dev_shm': _dev_shm(),
            'start_method': 'spawn', 'start_methods': multiprocessing.get_all_start_methods()}
    probe = {'modules': found, 'headers': headers, 'shared_objects': libs,
             'native': features, 'native_build_s': builds['image'].seconds,
             'native_build_error': builds['image'].error, 'reader': reader, 'pool': pool,
             'encoder': 'cv2' if found['cv2'] else 'numpy',
             'routes': {'png': {'decode': png_decode, 'resize': resize},
                        # JPEG needs an encoder (cv2) for the store and a decoder
                        'jpeg': ({'decode': jpeg_decode, 'resize': resize}
                                 if found['cv2'] and jpeg_decode else None)}}
    if png_decode is None:
        raise AssertionError('no PNG decode route on this host: {}'.format(probe))
    if not reader['available']:
        raise AssertionError('the native Parquet reader did not build or load: {}'.format(reader))
    if not pool['ring_available'] or found['zmq'] is None:
        raise AssertionError('the process pool cannot run on its shm transport: {} (pyzmq '
                             '{})'.format(pool, found['zmq']))
    return probe


def _store_cells(url, count):
    """The first ``count`` image cells of a store, as written, and the
    ``compressed_image`` field that decodes them."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl import get_schema

    path = os.path.join(url[len('file://'):], 'part-00000.parquet')
    table = pq.ParquetFile(path).read_row_groups(
        range(-(-count // IMAGE_ROWS_PER_ROW_GROUP)), columns=['image'])
    return table.column('image').slice(0, count), get_schema(url).fields['image']


@contextlib.contextmanager
def _env(**values):
    """``os.environ`` with ``values`` set, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _decode_rate(field, column, threads):
    """Images per second of the slice's decode+resize (the codec's
    ``decode_column`` with the resize target), row group by row group as the
    reader's workers run it, on ``threads`` threads."""
    import concurrent.futures

    import pyarrow as pa

    from petastorm_tpu_torch.codecs import image_routes

    groups = [pa.chunked_array([column.slice(i, IMAGE_ROWS_PER_ROW_GROUP).combine_chunks()])
              for i in range(0, len(column), IMAGE_ROWS_PER_ROW_GROUP)]

    def decode(group):
        block = field.codec.decode_column(field, group, min_size=(IMAGE_SIZE, IMAGE_SIZE),
                                          resize=(IMAGE_SIZE, IMAGE_SIZE))
        if block is None:  # the native route refused: the per-image route
            block = field.codec.decode_batch(field, group.to_pylist(),
                                             resize=(IMAGE_SIZE, IMAGE_SIZE))
        return len(block)

    work = groups * max(1, threads)
    image_routes.reset()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        done = sum(pool.map(decode, work))
    seconds = time.perf_counter() - t0
    return {'threads': threads, 'images': done, 'images_per_s': done / seconds,
            'ms_per_batch_of_64': seconds / done * BATCH * 1e3 * threads,
            'routes': image_routes.snapshot()}


def phase_decode_checks(png_url, png_images, jpeg_url, probe):
    """The port's image decode and resize routes against plain routes, and
    the host's decode+resize rate. Tolerances: decode exact (PNG is
    lossless); resize within 1 LSB of the plain route, the bound the JAX
    package states for its native resampler against cv2."""
    from petastorm_tpu_torch.codecs import (_area_resize_numpy, _bilinear_resize_numpy,
                                            _mild_ratio, _resize_image, image_routes)
    from petastorm_tpu_torch.native import image_codec

    native = probe['native'] is not None
    column, field = _store_cells(png_url, CHECK_IMAGES)
    checks = {}
    # decode: the reader's route on 256 store images, then every row filter,
    # gray and RGB, 8 and 16 bits
    image_routes.reset()
    decoded = field.codec.decode_column(field, column)
    if decoded is None:
        decoded = field.codec.decode_batch(field, column.to_pylist())
    exact = all(np.array_equal(a, b) for a, b in zip(decoded, png_images[:CHECK_IMAGES]))
    checks['store_png'] = {'images': CHECK_IMAGES, 'exact': exact,
                           'routes': image_routes.snapshot()}
    if not exact or len(decoded) != CHECK_IMAGES:
        raise AssertionError('decoded store images differ from the images written')
    gen = np.random.default_rng(SEED)
    filtered = [gen.integers(0, 256, (37, 50, 3), dtype=np.uint8),
                gen.integers(0, 256, (20, 33), dtype=np.uint8),
                gen.integers(0, 65536, (18, 21, 3), dtype=np.uint16),
                gen.integers(0, 65536, (9, 15), dtype=np.uint16),
                png_images[0]]
    cells = [png_bytes(img) for img in filtered]
    if native:
        out = image_codec.decode_images(cells)
        checks['filters_native_exact'] = all(np.array_equal(a, b) for a, b in zip(out, filtered))
    if probe['modules']['cv2']:
        import cv2
        out = [cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_UNCHANGED) for c in cells]
        out = [cv2.cvtColor(o, cv2.COLOR_BGR2RGB) if o.ndim == 3 else o for o in out]
        # OpenCV reads the same bytes: the encoder above writes valid PNGs
        checks['filters_cv2_exact'] = all(np.array_equal(a, b) for a, b in zip(out, filtered))
    if not all(v for k, v in checks.items() if k.startswith('filters')):
        raise AssertionError('filtered PNGs decode wrong: {}'.format(checks))

    # resize: each route against the plain route, upscale (the png path's
    # 160 px) and decimation (48 px: area where an axis shrinks 2x or more)
    images = png_images[:CHECK_IMAGES]
    resize = {}
    for target in ((IMAGE_SIZE, IMAGE_SIZE), (48, 48)):
        plain = [plain_resize(img, *target) for img in images]
        routes = {'policy_' + probe['routes']['png']['resize']:
                  [_resize_image(img, *target) for img in images]}
        if native:
            routes['native'] = [
                (image_codec.resize_bilinear_image if _mild_ratio(*img.shape[:2], *target)
                 else image_codec.resize_area_image)(img, target) for img in images]
            routes['native_fused'] = list(image_codec.decode_images_resized(
                column.to_pylist(), target))
        for name, outs in routes.items():
            resize['{}x{}_{}'.format(*target, name)] = _resize_errors(outs, plain)
    # the numpy route itself takes seconds per image: one small image, area
    # down and bilinear up
    small, targets = filtered[0], ((24, 24), (60, 90))
    resize['numpy_37x50'] = _resize_errors(
        [(_bilinear_resize_numpy if _mild_ratio(*small.shape[:2], *t) else _area_resize_numpy)(
            small, *t) for t in targets], [plain_resize(small, *t) for t in targets])
    checks['resize'] = resize
    bad = {k: v for k, v in resize.items() if v['max_abs_err'] > 1}
    if bad:
        raise AssertionError('resize routes beyond 1 LSB of the plain route: {}'.format(bad))

    # the host's rate for the slice's decode+resize
    rates = {}
    stores = [('png', png_url)] + ([('jpeg', jpeg_url)] if jpeg_url else [])
    for fmt, url in stores:
        col, fld = _store_cells(url, CHECK_IMAGES)
        with _env(PSTPU_IMG_THREADS='1'):  # one core: no native fan-out
            one = _decode_rate(fld, col, 1)
        rates[fmt] = {'one_core': one, 'pool': _decode_rate(fld, col, os.cpu_count() or 1)}
    emit({'phase': 'decode_checks', 'probe': probe, 'checks': checks, 'rates': rates,
          'host': _host_cpu()})
    image_routes.reset()


# -- the read checks -------------------------------------------------------------

def _row_worker(url, route):
    """A row worker of ``url`` that opens its files on ``route``: ``'native'``
    (the port's ``open_parquet``, as the reader's workers do) or
    ``'pyarrow'`` (``pq.ParquetFile``, the route without the native reader)."""
    import pyarrow.fs as pafs
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.etl import get_schema
    from petastorm_tpu_torch.row_worker import RowGroupDecoderWorker

    worker = RowGroupDecoderWorker(0, None, {'schema': get_schema(url),
                                             'filesystem': pafs.LocalFileSystem()})
    if route == 'pyarrow':
        worker._parquet_file = functools.lru_cache(maxsize=None)(pq.ParquetFile)
    return worker


def _load(worker, piece):
    """One row group's decoded block, as the reader's workers load it."""
    return worker._load_block(piece, list(worker.args['schema'].fields))


def _blocks_equal(a, b):
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
        for k in a)


def _read_rate(url, route, threads):
    """Rows per second, and decoded MB per second, of the row worker's load
    of every row group of ``url`` on ``route`` (``threads`` passes over the
    store on as many threads, a worker each), and the read routes counted."""
    import concurrent.futures

    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.native import read_routes

    pieces = load_row_groups(url)
    local = threading.local()

    def load(piece):
        worker = getattr(local, 'worker', None)
        if worker is None:
            worker = local.worker = _row_worker(url, route)
        block = _load(worker, piece)
        return len(block['label']), sum(v.nbytes for v in block.values())

    read_routes.reset()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        done = list(pool.map(load, pieces * threads))
    seconds = time.perf_counter() - t0
    rows = sum(n for n, _ in done)
    return {'threads': threads, 'rows': rows, 'rows_per_s': rows / seconds,
            'decoded_mb_per_s': sum(b for _, b in done) / seconds / 1e6,
            'routes': {k: v for k, v in read_routes.snapshot().items() if v}}


def phase_read_checks(raw_url, fixed_url):
    """The native Parquet reader against the routes without it, exactly, on
    every row group, with the routes each read took; then the host's read
    rates. Raw store: page-scan views against ``pq.ParquetFile`` + the
    codecs. Fixed-shape PNG store: the fused native call against the images
    as written and against the reader with the fused read switched off
    (``PSTPU_DISABLE_FUSED``: Arrow C++ reads, the codec decodes)."""
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.native import read_routes

    checks = {}
    pieces = load_row_groups(raw_url)
    native_worker, pyarrow_worker = _row_worker(raw_url, 'native'), _row_worker(raw_url, 'pyarrow')
    read_routes.reset()
    differ = [k for k, piece in enumerate(pieces)
              if not _blocks_equal(_load(native_worker, piece), _load(pyarrow_worker, piece))]
    routes = read_routes.snapshot()
    checks['raw'] = {'row_groups': len(pieces), 'differing_row_groups': differ, 'routes': routes}
    if differ or routes != {'fused_batches_total': 0, 'fused_columns_total': 0,
                            'fused_fallback_total': 0, 'arrow_fallback_columns_total': 0,
                            'pagescan_columns_total': 2 * len(pieces)}:
        raise AssertionError('raw store through the native reader: {}'.format(checks['raw']))

    pieces = load_row_groups(fixed_url)
    worker = _row_worker(fixed_url, 'native')
    read_routes.reset()
    fused = [_load(worker, piece) for piece in pieces]
    fused_routes = read_routes.snapshot()
    read_routes.reset()
    with _env(PSTPU_DISABLE_FUSED='1'):
        unfused = [_load(worker, piece) for piece in pieces]
    unfused_routes = read_routes.snapshot()
    images = np.concatenate([b['image'] for b in fused])
    labels = np.concatenate([b['label'] for b in fused])
    exact = (len(images) == ROWS and all(np.array_equal(images[i], _image(i)) for i in range(ROWS))
             and np.array_equal(labels, np.arange(ROWS) % NUM_CLASSES))
    checks['png_fixed'] = {
        'row_groups': len(pieces), 'exact_vs_written': exact,
        'differing_row_groups_vs_unfused': [k for k, (a, b) in enumerate(zip(fused, unfused))
                                            if not _blocks_equal(a, b)],
        'writable': all(v.flags.writeable for b in fused for v in b.values()),
        'routes': fused_routes, 'unfused_routes': unfused_routes}
    n = len(pieces)
    if not exact or checks['png_fixed']['differing_row_groups_vs_unfused'] or fused_routes != {
            'fused_batches_total': n, 'fused_columns_total': 2 * n, 'fused_fallback_total': 0,
            'arrow_fallback_columns_total': 0, 'pagescan_columns_total': 0} \
            or unfused_routes['arrow_fallback_columns_total'] != 2 * n:
        raise AssertionError('fixed-shape PNG store through the fused read: {}'.format(
            checks['png_fixed']))

    # the host's read rates: one core (no native fan-out), then a pool
    rates = {}
    for store, url, pairs in (('raw', raw_url, (('native', {}), ('pyarrow', {}))),
                              ('png_fixed', fixed_url, (('fused', {}), ('unfused', {
                                  'PSTPU_DISABLE_FUSED': '1'})))):
        for name, env in pairs:
            route = 'pyarrow' if name == 'pyarrow' else 'native'
            with _env(PSTPU_IMG_THREADS='1', **env):
                one = _read_rate(url, route, 1)
            with _env(**env):
                rates['{}_{}'.format(store, name)] = {
                    'one_core': one, 'pool': _read_rate(url, route, os.cpu_count() or 1)}
    emit({'phase': 'read_checks', 'checks': checks, 'rates': rates, 'host': _host_cpu()})
    read_routes.reset()


# -- the filter checks -----------------------------------------------------------

#: the png_fixed_pred path's predicate keeps these labels: a fixed 100-class
#: list, as ImageNet-100 subsets are drawn from ImageNet-1k
PRED_CLASSES = 100
#: the png_select path reads the first half of the store's synsets
SELECT_SYNSETS = ROWS // IMAGES_PER_SYNSET // 2
ROW_DROP_PARTITIONS = 2


def filter_predicates():
    """``name -> predicate``: the four predicates the filter checks hold the
    fused filtered read to, each evaluated natively on the int64 label."""
    from petastorm_tpu_torch.predicates import in_negate, in_range, in_reduce, in_set

    return {'in_set': in_set(range(PRED_CLASSES), 'label'),
            'in_range': in_range('label', lo=100, hi=299),
            'in_negate': in_negate(in_set(range(PRED_CLASSES), 'label')),
            'in_reduce': in_reduce([in_range('label', lo=100, hi=299),
                                    in_set(range(0, NUM_CLASSES, 2), 'label')], all)}


def selected_synsets():
    return ['n{:08d}'.format(s) for s in range(SELECT_SYNSETS)]


def _filtered_load(worker, piece, predicate):
    """One row group's filtered block, as the reader's workers load it
    (None when no row survives)."""
    return worker._load_block_with_predicate(piece, list(worker.args['schema'].fields),
                                             predicate, None)


def _filtered_rate(url, predicate):
    """Row groups and kept rows per second of the row worker's filtered
    load (``predicate``) or plain fused load (None) of every row group of
    ``url``, on one thread and one image thread."""
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups

    pieces = load_row_groups(url)
    worker = _row_worker(url, 'native')
    with _env(PSTPU_IMG_THREADS='1'):
        t0 = time.perf_counter()
        blocks = [_load(worker, piece) if predicate is None
                  else _filtered_load(worker, piece, predicate) for piece in pieces]
        seconds = time.perf_counter() - t0
    rows = sum(len(b['label']) for b in blocks if b)
    return {'row_groups': len(pieces), 'rows': rows, 'row_groups_per_s': len(pieces) / seconds,
            'rows_per_s': rows / seconds}


def phase_filter_checks(fixed_url, png_url, png_images, work_dir):
    """The fused filtered read on the fixed-shape PNG store against the
    images as written and against the Python pushdown (the fused read
    switched off), for four predicates, with the routes each read took; the
    row-group index over a copy of the PNG store (the ``png_select`` path
    reads that copy) and its selector; shuffle-row-drop partitions on the PNG
    store, one epoch; the host's filtered read rate on one core against the
    unfiltered fused read. Returns the URL of the indexed copy."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.etl import SingleFieldIndexer, build_rowgroup_index
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
    from petastorm_tpu_torch.native import read_routes
    from petastorm_tpu_torch.selectors import SingleIndexSelector

    import pyarrow.parquet as pq

    checks = {}
    pieces = load_row_groups(fixed_url)
    worker = _row_worker(fixed_url, 'native')
    labels = np.arange(ROWS) % NUM_CLASSES
    for name, predicate in filter_predicates().items():
        read_routes.reset()
        fused = [_filtered_load(worker, piece, predicate) for piece in pieces]
        routes = {k: v for k, v in read_routes.snapshot().items() if v}
        with _env(PSTPU_DISABLE_FUSED='1'):
            unfused = [_filtered_load(worker, piece, predicate) for piece in pieces]
        kept = [i for i in range(ROWS) if predicate.do_include({'label': labels[i]})]
        got_images = [img for b in fused if b for img in b['image']]
        got_labels = [int(v) for b in fused if b for v in b['label']]
        exact = (got_labels == [int(labels[i]) for i in kept] and len(got_images) == len(kept)
                 and all(np.array_equal(img, _image(i)) for img, i in zip(got_images, kept)))
        differ = [k for k, (a, b) in enumerate(zip(fused, unfused))
                  if (a is None) != (b is None) or (a is not None and not _blocks_equal(a, b))]
        n = len(pieces)
        checks[name] = {'rows': len(kept), 'row_groups_with_rows': sum(1 for b in fused if b),
                        'exact_vs_written': exact, 'differing_row_groups_vs_unfused': differ,
                        'routes': routes}
        if (not exact or differ or routes.get('fused_pred_batches_total') != n
                or routes.get('fused_batches_total') != n
                or routes.get('fused_columns_total') != 2 * n
                or routes.get('fused_pred_rows_selected') != len(kept)
                or any(k.startswith('fused_fallback') or k in (
                    'arrow_fallback_columns_total', 'pagescan_columns_total') for k in routes)):
            raise AssertionError('filtered read of the fixed-shape PNG store, {}: {}'.format(
                name, checks[name]))
    if not checks['in_set']['routes'].get('fused_pred_pages_skipped_total'):
        raise AssertionError('no page skipped by its statistics: {}'.format(checks['in_set']))

    # the row-group index, over a copy of the PNG store
    indexed = os.path.join(work_dir, 'png_indexed')
    shutil.copytree(png_url[len('file://'):], indexed)
    indexed_url = 'file://' + indexed
    t0 = time.perf_counter()
    build_rowgroup_index(indexed_url, [SingleFieldIndexer('noun_id_idx', 'noun_id')])
    index_s = time.perf_counter() - t0
    synsets = selected_synsets()
    picked = SingleIndexSelector('noun_id_idx', synsets).select_row_groups(
        get_row_group_indexes(indexed_url))
    # the store's row groups that hold a named synset
    nouns = pq.read_table(png_url[len('file://'):], columns=['noun_id']).column(
        'noun_id').to_pylist()
    expected = {i // IMAGE_ROWS_PER_ROW_GROUP for i, noun in enumerate(nouns) if noun in synsets}
    checks['index'] = {'build_s': index_s, 'synsets': len(synsets), 'row_groups': len(picked),
                       'exact': picked == expected}
    if picked != expected:
        raise AssertionError('the selector picked {} row groups, expected {}'.format(
            sorted(picked), sorted(expected)))

    # shuffle-row-drop partitions: every row of every row group once an epoch
    written = collections.Counter((noun, img.tobytes()) for noun, img in zip(nouns, png_images))
    t0 = time.perf_counter()
    with make_reader(png_url, output='columnar', schema_fields=['noun_id', 'image'],
                     shuffle_row_drop_partitions=ROW_DROP_PARTITIONS, seed=SEED, num_epochs=1,
                     workers_count=os.cpu_count() or 1) as reader:
        delivered = collections.Counter()
        items = 0
        for block in reader:
            items += 1
            delivered.update((noun, img.tobytes()) for noun, img in zip(block.noun_id,
                                                                        block.image))
    checks['row_drop'] = {'partitions': ROW_DROP_PARTITIONS, 'items': items,
                          'rows': sum(delivered.values()), 'exact': delivered == written,
                          'seconds': time.perf_counter() - t0}
    if delivered != written or items != ROW_DROP_PARTITIONS * len(load_row_groups(png_url)):
        raise AssertionError('row-drop partitions: {}'.format(checks['row_drop']))

    rates = {'filtered_in_set': _filtered_rate(fixed_url, filter_predicates()['in_set']),
             'unfiltered_fused': _filtered_rate(fixed_url, None)}
    emit({'phase': 'filter_checks', 'checks': checks, 'rates_one_core': rates,
          'host': _host_cpu()})
    read_routes.reset()
    return indexed_url


# -- the pool checks ------------------------------------------------------------

def raw_payload_bytes():
    """Ring bytes of one raw row group's in-place message: 64 images and 64
    int64 labels, the ring's 8-byte length prefix, the 9-byte protocol
    header and the serializer's pickled header (under 1 KiB)."""
    return ROWS_PER_ROW_GROUP * (IMAGE_SIZE * IMAGE_SIZE * 3 + 8) + 8 + 9 + 1024


def ring_bytes_needed(workers, payload_bytes, rows_per_payload, shuffle_capacity=SHUFFLE_CAPACITY,
                      batch=BATCH):
    """The least ring size per worker that cannot wedge a zero-copy reader
    feeding a shuffling loader (see :func:`ring_bytes_for`)."""
    pinned = -(-(shuffle_capacity + batch) // rows_per_payload) + 1
    return payload_bytes * (2 + -(-pinned // workers))


def ring_bytes_for(free_bytes, workers, payload_bytes, rows_per_payload,
                   shuffle_capacity=SHUFFLE_CAPACITY, batch=BATCH):
    """``(ring_bytes, needed)``: the per-worker ring size of a process pool
    of ``workers`` on a host whose ``/dev/shm`` has ``free_bytes`` free.

    ``RING_BYTES`` (ProcessPool's default) where ``workers`` of them fit in
    90% of ``free_bytes`` (the pool's own check), else what fits, in whole
    MiB. ``needed`` is the least that cannot wedge a zero-copy reader: a
    ring's bytes return to its worker in FIFO order as the consumer drops
    its views, and the consumer holds views of up to the shuffle buffer's
    capacity plus one batch of rows, in whole payloads, plus one being read;
    spread over the rings, plus one payload to write and one lost to the
    padding where a reserved message would wrap. Raises when what fits is
    smaller."""
    needed = ring_bytes_needed(workers, payload_bytes, rows_per_payload, shuffle_capacity, batch)
    ring = RING_BYTES
    if ring * workers > free_bytes * 0.9:
        ring = int(free_bytes * 0.9 / workers) >> 20 << 20
    if ring < needed:
        raise AssertionError('/dev/shm has {} bytes free: {} rings of {} bytes fit, {} are needed '
                             'per ring'.format(free_bytes, workers, ring, needed))
    return ring, needed


def _ring_round_trip():
    """The ring in one process, producer and consumer each on a handle of
    their own: every write and read call of the pool, byte for byte."""
    from petastorm_tpu_torch.native.shm_ring import ShmRing
    from petastorm_tpu_torch.workers.protocol import MSG_DATA, ring_header, ring_unpack

    name = '/pstpu_{}_smoke'.format(os.getpid())
    consumer = ShmRing.create(name, 1 << 20)
    producer = ShmRing.attach(name)
    gen = np.random.default_rng(SEED)
    a = gen.integers(0, 256, 300_000, dtype=np.uint8)
    b = gen.random(1000)
    checks = {}
    try:
        producer.write2(ring_header(MSG_DATA, 7), a.tobytes())
        checks['write2'] = ring_unpack(consumer.try_read_view())[:2] == (MSG_DATA, 7)
        producer.writev([ring_header(MSG_DATA, 8), a, b])
        kind, d, payload = ring_unpack(consumer.try_read_view())
        checks['writev'] = (kind, d) == (MSG_DATA, 8) and bytes(payload) == a.tobytes() + b.tobytes()
        view = producer.reserve(4096)
        view[:4] = b'torn'
        producer.abort()
        checks['abort'] = not consumer.has_message()
        # the third 300 kB message would wrap: the reservation pads to the
        # ring's start and stays contiguous, so the consumer borrows it
        for value in (1, 2, 3):
            view = producer.try_reserve(a.nbytes)
            np.frombuffer(view, np.uint8)[:] = a + value
            producer.commit(a.nbytes)
        taken = [consumer.try_read_zero_copy() for _ in range(3)]
        checks['reserve_commit_zero_copy'] = all(
            borrowed and bytes(v) == (a + value).tobytes()
            for value, (v, _, borrowed) in zip((1, 2, 3), taken))
        checks['full_while_borrowed'] = not producer.try_write2(b'', bytes(600_000))
        for v, span, _ in taken:
            v.release()
            consumer.release(span)
        checks['release'] = producer.try_write2(b'', bytes(600_000)) and len(
            consumer.try_read_view()) == 600_000
    finally:
        producer.close()
        consumer.close()
    if not all(checks.values()):
        raise AssertionError('ring round trip: {}'.format(checks))
    return checks


class KillOnceWorker(object):
    """The reader's row worker, which SIGKILLs its own process the first
    time it is handed row group ``args['kill_piece']`` (once across
    respawns, through the flag file ``args['flag_path']``), and fails if
    its process imported ``torch`` (module level, so spawned workers can
    unpickle it)."""

    def __init__(self, worker_id, publish_func, args):
        from petastorm_tpu_torch.row_worker import RowGroupDecoderWorker
        self._inner = RowGroupDecoderWorker(worker_id, publish_func, args)
        self._args = args

    def process(self, piece_index):
        if 'torch' in sys.modules:
            raise AssertionError('a spawned worker imported torch')
        if piece_index == self._args['kill_piece']:
            try:
                fd = os.open(self._args['flag_path'], os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                pass
            else:
                os.close(fd)
                os.kill(os.getpid(), signal.SIGKILL)
        self._inner.process(piece_index)

    def shutdown(self):
        self._inner.shutdown()


def _read_blocks(url, epochs, warm, check, **kwargs):
    """Every block a reader of ``url`` delivers over ``epochs`` epochs, in
    store order, handed to ``check`` and dropped. Returns the reader's start
    time (``make_reader`` until it returns: for a process pool, spawning its
    workers and their handshake), the seconds of each epoch (the first holds
    each worker's first-use costs: imports, opening libraries and files) and
    the rows/s of the epochs after the first ``warm``."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups

    per_epoch = len(load_row_groups(url))
    t0 = time.perf_counter()
    with make_reader(url, output='columnar', shuffle_row_groups=False, num_epochs=epochs,
                     workers_count=os.cpu_count() or 1, **kwargs) as reader:
        marks = [(time.perf_counter(), 0)]
        rows = blocks = 0
        for block in reader:
            check(block._asdict())
            rows += len(block.label)
            blocks += 1
            if blocks % per_epoch == 0:
                marks.append((time.perf_counter(), rows))
        # the pool's own counters (the reader's add the metrics registry)
        diagnostics = reader._pool.diagnostics
    (t_warm, rows_warm), (t_end, _) = marks[warm], marks[-1]
    return {'epochs': epochs, 'warm_epochs': warm, 'blocks': blocks, 'rows': rows,
            'start_s': marks[0][0] - t0,
            'epoch_s': [b[0] - a[0] for a, b in zip(marks, marks[1:])],
            'rows_per_s': (rows - rows_warm) / (t_end - t_warm), 'diagnostics': diagnostics}


def _check_pool_run(name, run, blocks, mismatched):
    diagnostics = run['diagnostics']
    if (mismatched or run['blocks'] != blocks or diagnostics['transport'] != 'shm'
            or diagnostics['worker_restarts'] or diagnostics['items_quarantined']):
        raise AssertionError('{}: {} blocks, {} differ from the thread pool\'s: {}'.format(
            name, run['blocks'], len(mismatched), diagnostics))


def phase_pool_checks(raw_url, fixed_url, probe, work_dir):
    """The ring in one process; the process pool's blocks against the
    thread pool's, exactly, on the raw store (copy mode and zero-copy,
    ``POOL_EPOCHS`` epochs) and the fixed-shape PNG store (two); a worker
    killed mid-item; the host's rows/s through each pool, each epoch's
    seconds and each pool's start time. Returns the ring size the process
    paths use."""
    import pyarrow.fs as pafs

    from petastorm_tpu_torch.cache import NullCache
    from petastorm_tpu_torch.errors import EmptyResultError
    from petastorm_tpu_torch.etl import get_schema
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.serializers import NumpyBlockSerializer
    from petastorm_tpu_torch.workers import ProcessPool

    workers = os.cpu_count() or 1
    ring, needed = ring_bytes_for(probe['pool']['dev_shm']['free_bytes'], workers,
                                  raw_payload_bytes(), ROWS_PER_ROW_GROUP)
    emit({'phase': 'pool_sizing', 'workers': workers, 'ring_bytes': ring,
          'ring_bytes_needed': needed, 'payload_bytes': raw_payload_bytes(),
          'dev_shm': probe['pool']['dev_shm']})
    checks = {'ring': _ring_round_trip()}
    pool_kwargs = {'ring_bytes': ring, 'transport': 'shm'}
    runs, references = {}, {}
    for store, url, epochs, warm in (('raw', raw_url, POOL_EPOCHS, POOL_WARM_EPOCHS),
                                     ('png_fixed', fixed_url, 2, 1)):
        reference = references[store] = {}

        def keep(block, reference=reference):
            reference.setdefault(tuple(block['label']), {k: np.array(v) for k, v in block.items()})

        runs[store + '_thread'] = _read_blocks(url, epochs, warm, keep)
        blocks = runs[store + '_thread']['blocks']
        for mode in (('copy', 'zero_copy') if store == 'raw' else ('copy',)):
            mismatched = []

            def compare(block, reference=reference, mismatched=mismatched):
                if not _blocks_equal(block, reference.get(tuple(block['label']), {})):
                    mismatched.append(int(block['label'][0]))

            run = _read_blocks(url, epochs, warm, compare, reader_pool_type='process',
                               zero_copy=mode == 'zero_copy', pool_kwargs=pool_kwargs)
            _check_pool_run('{} {}'.format(store, mode), run, blocks, mismatched)
            runs['{}_process_{}'.format(store, mode)] = run

    # a worker SIGKILLed mid-item: the pool respawns it and requeues the item
    schema = get_schema(raw_url)
    pieces = load_row_groups(raw_url)
    pool = ProcessPool(workers, serializer=NumpyBlockSerializer(), results_timeout_s=120,
                       **pool_kwargs)
    pool.start(KillOnceWorker, {
        'filesystem': pafs.LocalFileSystem(), 'dataset_path': raw_url[len('file://'):],
        'cache': NullCache(), 'pieces': pieces, 'schema': schema, 'output_schema': schema,
        'transform_spec': None, 'transformed_schema': schema, 'kill_piece': len(pieces) // 2,
        'flag_path': os.path.join(work_dir, 'killed')})
    delivered = []
    try:
        for i in range(len(pieces)):
            pool.ventilate(piece_index=i)
        while True:
            try:
                block = pool.get_results()
            except EmptyResultError:
                break
            key = tuple(block['label'])
            delivered.append(key)
            if not _blocks_equal(block, references['raw'].get(key, {})):
                raise AssertionError('a row group after the kill differs from the thread pool\'s')
            del block
    finally:
        pool.stop()
        pool.join()
    diag = pool.diagnostics
    checks['kill'] = {'row_groups': len(pieces), 'delivered': len(delivered),
                      'distinct': len(set(delivered)), 'killed': os.path.exists(
                          os.path.join(work_dir, 'killed')), 'diagnostics': diag}
    if sorted(delivered) != sorted(references['raw']) or not checks['kill']['killed'] \
            or diag['worker_restarts'] < 1 or diag['items_requeued'] < 1 \
            or diag['items_quarantined']:
        raise AssertionError('a worker killed mid-item: {}'.format(checks['kill']))
    emit({'phase': 'pool_checks', 'checks': checks, 'runs': runs, 'host': _host_cpu()})
    return ring


def check_pool(path, pool, read_counts):
    """A process path ran on the process pool's shm transport with no
    restart and no quarantined item, and published by the channel the slice
    names for it: ``raw_process`` in place only (zero-copy delivery, one
    publish per fused batch); ``png_process`` by blob only."""
    if not path.endswith('_process'):
        return
    from petastorm_tpu_torch.workers.process_pool import PUBLISH_CHANNELS

    publishes = {k: pool.get(k) for k in PUBLISH_CHANNELS}
    channel = 'publish_inplace' if path == 'raw_process' else 'publish_blob'
    ok = (pool.get('transport') == 'shm' and not pool['worker_restarts']
          and not pool['items_quarantined'] and publishes[channel] > 0
          and not any(v for k, v in publishes.items() if k != channel)
          and pool['zero_copy'] == (path == 'raw_process'))
    if path == 'raw_process':
        ok = ok and publishes[channel] == read_counts.get('fused_inplace_batches_total')
    if not ok:
        raise AssertionError('{}: not on the process pool\'s named channel: {}'.format(path, pool))


def check_no_leftovers():
    """No zero-copy borrow is live and no ``/dev/shm`` entry of this
    process's rings or blob dirs is left."""
    import gc

    from petastorm_tpu_torch.native.lifetime import registry

    gc.collect()
    live = registry().counters()['lifetime_live_borrows']
    left = sorted(f for f in os.listdir('/dev/shm')
                  if f.startswith(('pstpu_{}_'.format(os.getpid()),
                                   'pstpu_blobs_{}_'.format(os.getpid()))))
    if live or left:
        raise AssertionError('{} live borrows, /dev/shm entries left: {}'.format(live, left))


def check_image_batch(expected):
    """A check of a staged batch against ``expected`` (label -> the images
    of the store under that label, decoded and resized by the plain route):
    each staged image is within 1 LSB of one of its label's images."""
    def check(images, labels):
        for image, label in zip(images, labels):
            if not any(_max_err(image, e) <= 1 for e in expected.get(int(label), ())):
                raise AssertionError('a staged image matches no stored row of label {} within '
                                     '1 LSB'.format(label))
    return check


def expected_images(url, written, route):
    """label -> the store's images through the plain route: the images as
    written (PNG) or the stored cells decoded by the decode route (JPEG),
    resized by :func:`plain_resize`."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.native import image_codec

    table = pq.read_table(os.path.join(url[len('file://'):], 'part-00000.parquet'),
                          columns=['noun_id', 'image'])
    labels = [label_of(n) for n in table.column('noun_id').to_pylist()]
    if written:
        images = written
    elif route == 'native':
        images = image_codec.decode_images(table.column('image').to_pylist(),
                                           min_size=(IMAGE_SIZE, IMAGE_SIZE))
    else:
        import cv2
        images = [cv2.cvtColor(cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_COLOR),
                               cv2.COLOR_BGR2RGB) for c in table.column('image').to_pylist()]
    expected = {}
    for label, img in zip(labels, images):
        expected.setdefault(label, []).append(plain_resize(img, IMAGE_SIZE, IMAGE_SIZE))
    return expected


def check_routes(counts, routes):
    """Images went only through the named decode and resize routes; with
    ``routes=None``, through none of the codec's routes."""
    allowed = set()
    if routes is not None:
        allowed.add('resize_' + routes['resize'])
        allowed |= ({'decode_native'} if routes['decode'] == 'native'
                    else {'decode_cv2', 'decode_fallback'})
    unexpected = {k: v for k, v in counts.items() if v and k not in allowed}
    if unexpected:
        raise AssertionError('images on unexpected routes {} (named: {})'.format(
            unexpected, routes))


def check_read_routes(path, counts):
    """The columns of a path's run went through the read routes the slice
    names for it: ``raw`` page-scan views only; ``png`` and ``jpeg`` images
    to the codec's columnar decode (reason ``image-hints``: a resize target)
    and ``noun_id``/``text`` (reason ``codec``: strings), through Arrow;
    ``png_cached`` no read at all, nor ``png_served`` (the daemon reads);
    ``raw_elastic`` as ``raw``;
    ``png_fixed`` fused only; ``png_process``
    as ``png``; ``raw_process`` fused only, every fused batch decoded in
    place into a ring slot, two columns each; ``png_fixed_pred`` every row
    group through the fused predicate call, two columns each, with pages
    skipped by their statistics; ``png_select`` all three columns through
    Arrow (a shuffle-row-drop partition is a row subset, which the row
    worker reads through Arrow's ``take`` without planning a fused read, so
    no fallback reason is counted); ``plain_batch`` the raw ``label`` column
    through the fused read with no schema (one column each) and the
    ``binary`` image column through Arrow (reason ``codec``: not a
    fixed-width numeric column); ``seq_ring``, ``seq_ulysses`` and
    ``seq_moe`` all three telemetry columns through the fused read (a window
    block is assembled from the decoded row group, so none in place)."""
    def c(key):
        return counts.get(key, 0)

    reasons = {k.split(':', 1)[1]: v for k, v in counts.items()
               if k.startswith('fused_fallback_reason:') and v}
    fused, fallback = c('fused_batches_total'), c('fused_fallback_total')
    pagescan, arrow = c('pagescan_columns_total'), c('arrow_fallback_columns_total')
    if path in ('raw', 'raw_mesh', 'raw_elastic'):
        ok = pagescan > 0 and not (fused or fallback or arrow or reasons)
    elif path in ('png', 'jpeg', 'png_process'):
        n = reasons.get('image-hints', 0)
        ok = (n > 0 and reasons == {'image-hints': n, 'codec': 2 * n} and fallback == 3 * n
              and arrow == 3 * n and not (fused or pagescan))
    elif path in ('png_cached', 'png_served'):
        ok = not any(counts.values())
    elif path == 'png_fixed_pred':
        ok = (fused > 0 and c('fused_pred_batches_total') == fused
              and c('fused_columns_total') == 2 * fused and c('fused_pred_pages_skipped_total') > 0
              and not any(':predicate' in k for k in counts)
              and not (fallback or arrow or pagescan or reasons))
    elif path == 'png_select':
        ok = arrow > 0 and arrow % 3 == 0 and not (fused or fallback or pagescan or reasons)
    elif path == 'plain_batch':
        ok = (fused > 0 and c('fused_columns_total') == fused and reasons == {'codec': fused}
              and fallback == fused and arrow == fused and not pagescan)
    elif path in ('seq_ring', 'seq_ulysses', 'seq_moe'):
        ok = (fused > 0 and c('fused_columns_total') == 3 * fused
              and not (fallback or arrow or pagescan or reasons or
                       c('fused_inplace_batches_total')))
    elif path == 'raw_process':
        ok = (fused > 0 and c('fused_inplace_batches_total') == fused
              and c('fused_columns_total') == 2 * fused
              and not (fallback or arrow or pagescan or reasons))
    else:  # png_fixed
        ok = (fused > 0 and c('fused_columns_total') == 2 * fused
              and not (fallback or arrow or pagescan or reasons))
    if not ok:
        raise AssertionError('{}: columns read by unexpected routes: {}'.format(path, counts))


def check_labels(what, ok):
    """A check of every label a filtered path delivered: ``ok(labels)`` is a
    boolean mask over them."""
    def check(labels):
        bad = labels[~np.asarray(ok(labels), dtype=bool)]
        if len(bad) or not len(labels):
            raise AssertionError('{} labels delivered, {} not {}: {}'.format(
                len(labels), len(bad), what, sorted(set(bad.tolist()))[:10]))
    return check


def new_train_state(torch):
    from petastorm_tpu_torch.models import resnet50
    from petastorm_tpu_torch.models.train import create_train_state

    torch.manual_seed(SEED)
    return create_train_state(resnet50(num_classes=NUM_CLASSES, dtype=torch.bfloat16))


#: staged batches of a graphed run that an eager step from the same seed
#: runs again: the first two are the graphed step's eager warm-up steps, the
#: third its capture and first replay, the fourth a replay
SAME_BATCHES = 4


#: the stall report's stages each path's routes imply: ``(named, absent)``
#: (``read_io`` is the Arrow/page-scan read, ``decode`` the codec decode,
#: ``fused_decode``/``fused_predicate`` the fused native call)
STALL_STAGES = {
    'raw': ({'worker.read_io'}, {'worker.fused_decode'}),
    'raw_mesh': ({'worker.read_io'}, {'worker.fused_decode'}),
    # the wait at the pod's epoch barrier has no stage of its own: the pool
    # wait is shared out over the timed worker stages, here the read
    'raw_elastic': ({'worker.read_io'}, {'worker.fused_decode'}),
    'png': ({'worker.decode', 'worker.read_io'}, {'worker.fused_decode'}),
    'jpeg': ({'worker.decode'}, {'worker.fused_decode'}),
    'png_process': ({'worker.decode'}, {'worker.fused_decode'}),
    'png_select': ({'worker.decode'}, {'worker.fused_decode'}),
    'png_fixed': ({'worker.fused_decode'}, {'worker.decode', 'worker.read_io'}),
    'raw_process': ({'worker.fused_decode'}, {'worker.decode', 'worker.read_io'}),
    'png_fixed_pred': ({'worker.fused_predicate'}, {'worker.decode', 'worker.read_io'}),
    'png_cached': (set(), {'worker.decode', 'worker.read_io', 'worker.fused_decode'}),
    # the daemon's workers decode: their timers are not in the trainer's
    # registry, so its pool wait stays unattributed
    'png_served': ({'pool.unattributed'},
                   {'worker.decode', 'worker.read_io', 'worker.fused_decode'}),
    'seq_ring': ({'worker.fused_decode'}, {'worker.decode', 'worker.read_io'}),
    'seq_ulysses': ({'worker.fused_decode'}, {'worker.decode', 'worker.read_io'}),
}


def check_stall(name, stall):
    """A path's stall report names the stages of its routes, and none of
    the routes it does not take (``STALL_STAGES``); its pool wait falls on
    timed worker stages (no ``pool.unattributed``: the workers' timers
    reached the consumer), except on a served path, whose workers run in the
    daemon."""
    named, absent = STALL_STAGES.get(name, (set(), set()))
    absent = absent | ({'pool.unattributed'} - named)
    stages = set(stall['stages'])
    if not named <= stages or stages & absent:
        raise AssertionError('{}: the stall report names {}; its routes imply {} and not '
                             '{}'.format(name, sorted(stages), sorted(named), sorted(absent)))


def run_path(torch, name, url, check, reader_kwargs=None, routes=None, label_check=None,
             graphed=False, reader_factory=None, telemetry='counters', steps=STEPS, tag=None,
             on_step=None, mesh=None):
    """One path: a fresh model from the seed, 3 warm-up and ``steps``
    measured steps through ``pipeline_duty_cycle``, with the eager step or
    (``graphed``) the graphed one, at the ``telemetry`` level. The normalize
    launches (a graph replay adds the launches it captured), the image route
    counts, the read route counts and the telemetry registry and span ring
    cover this run alone. ``label_check`` is handed every label the steps
    saw, after the run (the labels stay on the card until then: no
    synchronisation in the steps); ``on_step`` is called after each step.
    The line carries the stall report of the loader's diagnostics
    (``stall``), checked against the path's routes. Returns the launches,
    the state, the step, the first :data:`SAME_BATCHES` staged batches, the
    result and the losses. With a ``mesh``, the example's mesh flow: the
    state sharded onto it, the reader on this rank's shard
    (``reader_shard_for_process``) and the batches staged onto its data
    sharding."""
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.codecs import image_routes
    from petastorm_tpu_torch.models.train import make_train_step
    from petastorm_tpu_torch.ops.kernels import normalize as nk
    from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle

    state = new_train_state(torch)
    kwargs = {'seed': SEED, 'shuffle_row_groups': True,
              'workers_count': max(1, os.cpu_count() or 1), **(reader_kwargs or {})}
    factory = {} if reader_factory is None else {'reader_factory': reader_factory}
    if mesh is not None:
        from petastorm_tpu_torch.models.train import shard_train_state
        from petastorm_tpu_torch.parallel import data_sharding, reader_shard_for_process

        state = shard_train_state(state, mesh)
        kwargs['cur_shard'], kwargs['shard_count'] = reader_shard_for_process(mesh)
        factory['to_device'] = data_sharding(mesh)
    train_step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED, graphed=graphed)
    losses = []
    first_batches = []
    seen_labels = []

    def step_fn(images, labels):
        if not losses:
            # first warm-up step: the batch on the card is rows of the store
            if images.dtype != torch.uint8 or tuple(images.shape) != (
                    BATCH, IMAGE_SIZE, IMAGE_SIZE, 3) or images.device.type != DEVICE_TYPE:
                raise AssertionError('staged batch: {} {} on {}'.format(
                    images.dtype, tuple(images.shape), images.device))
            check(images.cpu().numpy(), labels.cpu().numpy())
        if len(first_batches) < SAME_BATCHES:
            first_batches.append((images, labels))
        _, metrics = train_step(state, images, labels)
        losses.append(metrics['loss'])
        if label_check is not None:
            seen_labels.append(labels)
        if on_step is not None:
            on_step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    image_routes.reset()
    obs.get_registry().reset()
    obs.get_ring().clear()
    nk.launches = 0
    t0 = time.perf_counter()
    result = pipeline_duty_cycle(
        url, step_fn, lambda b: (b['image'], b['label']), batch_size=BATCH, steps=steps,
        warmup_steps=WARMUP_STEPS, reader_kwargs=kwargs,
        loader_kwargs={'shuffling_queue_capacity': SHUFFLE_CAPACITY, 'seed': SEED},
        telemetry=telemetry, **factory)
    wall_s = time.perf_counter() - t0
    launches = {'normalize': nk.launches}
    counts = image_routes.snapshot()
    losses = [float(x) for x in losses]
    stall = result.extra['stall']
    emit({'phase': 'path', 'path': name, 'step': 'graphed' if graphed else 'eager',
          'tag': tag, 'telemetry': getattr(telemetry, 'level', telemetry),
          'model': 'resnet50', 'dtype': 'bfloat16',
          'num_classes': NUM_CLASSES, 'batch_size': BATCH, 'image_size': IMAGE_SIZE,
          'rows': ROWS, 'warmup_steps': WARMUP_STEPS, 'steps': steps,
          'examples_per_sec': result.samples_per_second,
          'input_stall_fraction': result.input_stall_fraction,
          'median_step_ms': result.extra['median_step_ms'],
          'step_ms': result.extra['step_ms'],
          'peak_memory_bytes': torch.cuda.max_memory_allocated(),
          'losses': losses, 'launches': launches, 'image_routes': counts,
          'named_routes': routes, 'read_routes': result.extra['read_routes'],
          'cache': result.extra['cache'], 'pool': result.extra['pool'],
          'stall': stall, 'wall_s': wall_s,
          # every stage timer's seconds over the run: the workers' and the
          # loader's and infeed's, which run on the prefetch thread outside
          # the reader wait the stall report splits
          'stage_s': {k[len('stage_'):-2]: v
                      for k, v in sorted(result.extra['diagnostics'].items())
                      if k.startswith('stage_') and k.endswith('_s')},
          'stage_count': {k[len('stage_'):-6]: v
                          for k, v in sorted(result.extra['diagnostics'].items())
                          if k.startswith('stage_') and k.endswith('_count')}})
    if telemetry == 'off':
        if stall is not None:
            raise AssertionError('{}: a stall report with telemetry off'.format(name))
    else:
        check_stall(name, stall)
    if len(losses) != WARMUP_STEPS + steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError('{}: losses {}'.format(name, losses))
    # zero-initialised last batch norms make the fresh model's logits small:
    # the first loss is close to log(classes)
    if abs(losses[0] - math.log(NUM_CLASSES)) > 1.0:
        raise AssertionError('{}: first loss {} is far from log({}) = {}'.format(
            name, losses[0], NUM_CLASSES, math.log(NUM_CLASSES)))
    for kernel, count in launches.items():
        if count < WARMUP_STEPS + steps:
            raise AssertionError('{}: kernel {} launched {} times in {} steps'.format(
                name, kernel, count, WARMUP_STEPS + steps))
    if label_check is not None:
        label_check(torch.cat(seen_labels).cpu().numpy())
    check_routes(counts, routes)
    check_read_routes(name, result.extra['read_routes'])
    check_pool(name, result.extra['pool'], result.extra['read_routes'])
    return launches, state, train_step, first_batches, result, losses


def preprocess(images, mask):
    """The paths' on-device input ops: the step's flip mask, then normalize
    (the Triton kernel) to bf16."""
    from petastorm_tpu_torch.ops import normalize_images
    from petastorm_tpu_torch.ops.augment import flip_with_mask

    return normalize_images(flip_with_mask(images, mask), IMAGENET_MEAN, IMAGENET_STD)


#: the graphed step against the eager one on the same batches: the first
#: losses (both eager forwards of one fresh model) within the slice tests'
#: 1e-3; a replay's within 1e-2, since bf16 convolutions on the card need not
#: be bit-reproducible
FIRST_LOSS_TOL = 1e-3
REPLAY_LOSS_TOL = 1e-2


def check_graphed_losses(torch, name, graphed_losses, batches):
    """A fresh eager state from the seed trains on the graphed run's first
    staged batches: its losses must be the graphed run's."""
    from petastorm_tpu_torch.models.train import make_train_step

    state = new_train_state(torch)
    step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED)
    eager = [float(step(state, images, labels)[1]['loss']) for images, labels in batches]
    diffs = [abs(a - b) for a, b in zip(eager, graphed_losses)]
    emit({'phase': 'graph_check', 'path': name, 'eager_losses': eager,
          'graphed_losses': graphed_losses[:len(eager)], 'abs_diff': diffs,
          'tolerance': {'first': FIRST_LOSS_TOL, 'replays': REPLAY_LOSS_TOL}})
    if diffs[0] > FIRST_LOSS_TOL or max(diffs) > REPLAY_LOSS_TOL:
        raise AssertionError('{}: the graphed step\'s losses {} are not the eager step\'s {} '
                             'on the same batches'.format(name, graphed_losses[:len(eager)], eager))


def run_path_both_ways(torch, name, url, check, **kwargs):
    """The path with the eager step, then with the graphed step, in one call
    (host numbers move between calls), then the graphed run's first batches
    through a fresh eager step. Returns the launches over both runs and each
    run's ``(state, step, first batches, result)``."""
    runs = {}
    total = collections.Counter()
    for graphed in (False, True):
        launches, state, step, batches, result, losses = run_path(
            torch, name, url, check, graphed=graphed, **kwargs)
        total.update(launches)
        runs['graphed' if graphed else 'eager'] = (state, step, batches, result)
    check_graphed_losses(torch, name, losses, runs['graphed'][2])
    return total, runs


#: the serve daemon of ``png_served`` evicts a consumer blocked this long; the
#: daemon's default (10 s) could evict the trainer while it captures its graph
SERVE_EVICT_BLOCK_S = 120.0
#: ``serve_checks``' eviction: a 64 KiB ring, a consumer blocked 0.3 s is
#: evicted, over this many epochs of the raw store's label column (a frame
#: of 64 labels is under 1 KiB: the ring fills after about 90 of them)
SERVE_CHECK_RING = 64 << 10
SERVE_CHECK_EVICT_S = 0.3
SERVE_CHECK_EPOCHS = 30
#: row groups of the PNG store, one epoch of its served stream
PNG_ROW_GROUPS = ROWS // IMAGE_ROWS_PER_ROW_GROUP


def served_payload_bytes():
    """Bytes of one decoded PNG row group (16 resized images and their
    labels) with its framing, as :func:`raw_payload_bytes`."""
    return IMAGE_ROWS_PER_ROW_GROUP * (IMAGE_SIZE * IMAGE_SIZE * 3 + 8) + 8 + 9 + 1024


def block_key(block):
    """A served block's identity: its labels and a crc32 of its images."""
    return [[int(v) for v in block.label], zlib.crc32(np.ascontiguousarray(block.image))]


def served_spec_kwargs():
    """``make_reader`` arguments of the ``png_served`` stream besides
    ``serve``: the ``png`` path's as ``run_path`` and ``pipeline_duty_cycle``
    pass them. The transform comes from this module imported by name, so its
    pickle (part of the stream's id) is the same in the trainer, the second
    tenant and the daemon that unpickles it."""
    import chip_smoke

    return {'seed': SEED, 'shuffle_row_groups': True, 'num_epochs': None,
            'output': 'columnar', 'transform_spec': chip_smoke.image_transform()}


def served_tenant(url, svc_dir, stop_path, out_path):
    """``png_served``'s second tenant, in a host process of its own that
    imports no torch: attaches the trainer's stream, drains it until
    ``stop_path`` exists, and writes each block's ``(seq, key)``, its frames
    by kind and its rows/s to ``out_path``."""
    from petastorm_tpu_torch import make_reader

    records = []
    with make_reader(url, serve=svc_dir, **served_spec_kwargs()) as reader:
        with open(out_path + '.attached', 'w'):
            pass
        t0 = time.perf_counter()
        for block in reader:
            records.append([reader._facade.last_result_seq, block_key(block)])
            if os.path.exists(stop_path):
                break
        seconds = time.perf_counter() - t0
        out = {'stream_id': reader.stream_id, 'tenant_id': reader.tenant_id,
               'frames': dict(reader._facade.frames), 'records': records,
               'rows': sum(len(k[0]) for _, k in records), 'seconds': seconds,
               'torch_imported': 'torch' in sys.modules}
    out['rows_per_s'] = out['rows'] / seconds
    with open(out_path, 'w') as f:
        json.dump(out, f)


class ServedRecorder(object):
    """The served reader a path's loader iterates, recording each block's
    ``(seq, key)``; every other attribute is the reader's."""

    def __init__(self, reader, records):
        self._reader = reader
        self._records = records

    def __iter__(self):
        return self

    def __next__(self):
        block = next(self._reader)
        self._records.append([self._reader._facade.last_result_seq, block_key(block)])
        return block

    def __getattr__(self, name):
        return getattr(self._reader, name)


def _daemon_segments(pid):
    """The ``/dev/shm`` rings and blob dirs of daemon ``pid``."""
    tag = '_{}_'.format(pid)
    return sorted(e for e in os.listdir('/dev/shm') if e.startswith('pstpu') and tag in e)


def _mapped_gpu_libraries(pid):
    """The libraries of torch, JAX or the CUDA driver a process has mapped."""
    with open('/proc/{}/maps'.format(pid)) as f:
        paths = {line.split()[-1] for line in f if '.so' in line}
    return sorted(p for p in paths if '/torch/' in p or '/jax' in p or 'libcuda' in p)


def start_daemon(svc_dir, ring_bytes, workers, evict_block_s=None):
    """``python -m petastorm_tpu_torch.serve`` in the background on a thread
    fleet of ``workers``; returns its ``Popen`` once its endpoint answers."""
    from petastorm_tpu_torch.serve.service import read_endpoint

    os.makedirs(svc_dir, exist_ok=True)
    cmd = [sys.executable, '-m', 'petastorm_tpu_torch.serve', '--service-dir', svc_dir,
           '--workers-count', str(workers), '--ring-bytes', str(ring_bytes),
           '--idle-timeout', '0']
    if evict_block_s is not None:
        cmd += ['--evict-block', str(evict_block_s)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''))
    with open(os.path.join(svc_dir, 'daemon.log'), 'ab') as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=log, env=env, cwd=ROOT)
    deadline = time.monotonic() + 60
    while (read_endpoint(svc_dir) or {}).get('pid') != proc.pid:
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError('the serve daemon did not start: {}'.format(
                _daemon_log(svc_dir)))
        time.sleep(0.05)
    return proc


def _daemon_log(svc_dir):
    try:
        with open(os.path.join(svc_dir, 'daemon.log')) as f:
            return f.read()[-4000:]
    except OSError:
        return ''


def service_stats(svc_dir):
    from petastorm_tpu_torch.serve import connect_service

    conn = connect_service(svc_dir)
    try:
        conn.send({'op': 'stats'})
        return conn.recv()['stats']
    finally:
        conn.close()


def stop_daemon(proc, svc_dir):
    """Shut the daemon down through its control socket: it must exit with
    code 0 and leave no ``/dev/shm`` segment. Returns its shutdown seconds."""
    from petastorm_tpu_torch.serve import connect_service

    t0 = time.perf_counter()
    conn = connect_service(svc_dir)
    conn.send({'op': 'shutdown'})
    conn.recv()
    conn.close()
    rc = proc.wait(timeout=60)
    seconds = time.perf_counter() - t0
    left = _daemon_segments(proc.pid)
    if rc != 0 or left:
        raise AssertionError('serve daemon pid {} exited {} leaving {}: {}'.format(
            proc.pid, rc, left, _daemon_log(svc_dir)))
    return seconds


def _check_served_epochs(name, records, store_keys=None):
    """Each epoch of a tenant's ``(seq, key)`` records (epoch = seq // row
    groups: the fair-share ventilator dispatches one stream epoch by epoch)
    holds each row group at most once, and a complete epoch all of them.
    Returns the key set of a complete epoch and the complete epochs."""
    epochs = collections.defaultdict(list)
    for seq, key in records:
        epochs[seq // PNG_ROW_GROUPS].append(json.dumps(key))
    complete = 0
    for epoch, keys in sorted(epochs.items()):
        if len(set(keys)) != len(keys):
            raise AssertionError('{}: epoch {} delivered a row group twice'.format(name, epoch))
        if len(keys) == PNG_ROW_GROUPS:
            complete += 1
            if store_keys is None:
                store_keys = set(keys)
            if set(keys) != store_keys:
                raise AssertionError('{}: epoch {} is not the store\'s rows'.format(name, epoch))
    return store_keys, complete


def phase_png_served(torch, png_url, png_check, png_runs, work_dir, ring):
    """``png_served``: the ``png`` path read through the shared reader
    daemon (``python -m petastorm_tpu_torch.serve``, a thread fleet of one
    worker per core, a ``ring``-byte broadcast ring), with a second tenant
    in a host process of its own draining the same stream while the card
    trains. Checks: both tenants get the same block for every seq they both
    received and, each epoch, every row group once; the daemon decoded each
    dispatched row group once for both; the 16-row batches (1.2 MB) came by
    blob; the labels are the store's; the graphed step's losses are the
    eager one's; neither the daemon nor the second tenant imported torch or
    mapped a GPU library. Returns the launches."""
    workers = max(1, os.cpu_count() or 1)
    svc_dir = os.path.join(work_dir, 'svc')
    stop_path = os.path.join(work_dir, 'served_tenant.stop')
    out_path = os.path.join(work_dir, 'served_tenant.json')
    daemon = start_daemon(svc_dir, ring, workers, evict_block_s=SERVE_EVICT_BLOCK_S)
    tenant = None
    records = []
    readers = []
    try:
        code = 'import chip_smoke; chip_smoke.served_tenant({!r}, {!r}, {!r}, {!r})'.format(
            png_url, svc_dir, stop_path, out_path)
        tenant = subprocess.Popen([sys.executable, '-c', code], cwd=ROOT)
        deadline = time.monotonic() + 60
        while not os.path.exists(out_path + '.attached'):
            if tenant.poll() is not None or time.monotonic() > deadline:
                raise AssertionError('the second tenant did not attach')
            time.sleep(0.05)

        def factory(url, **kwargs):
            from petastorm_tpu_torch import make_reader

            reader = make_reader(url, serve=svc_dir, **kwargs)
            readers.append(reader)
            return ServedRecorder(reader, records)

        labels = sorted({label_of('n{:08d}'.format(s))
                         for s in range(ROWS // IMAGES_PER_SYNSET)})
        total, runs = run_path_both_ways(
            torch, 'png_served', png_url, png_check,
            reader_kwargs={'transform_spec': served_spec_kwargs()['transform_spec'],
                           'output': 'columnar'},
            reader_factory=factory,
            label_check=check_labels('of a stored synset', lambda v: np.isin(v, labels)))
        stats = service_stats(svc_dir)
        with open(stop_path, 'w'):
            pass
        if tenant.wait(timeout=120) != 0:
            raise AssertionError('the second tenant failed')
        with open(out_path) as f:
            second = json.load(f)
        daemon_libs = _mapped_gpu_libraries(daemon.pid)
    finally:
        if tenant is not None and tenant.poll() is None:
            tenant.kill()
            tenant.wait()
        shutdown_s = stop_daemon(daemon, svc_dir)
    stream_ids = {r.stream_id for r in readers} | {second['stream_id']}
    stream = stats['streams'][second['stream_id']]
    ours = dict((seq, json.dumps(key)) for seq, key in records)
    theirs = dict((seq, json.dumps(key)) for seq, key in second['records'])
    common = sorted(set(ours) & set(theirs))
    differ = [s for s in common if ours[s] != theirs[s]]
    store_keys, second_complete = _check_served_epochs('png_served second tenant',
                                                       second['records'])
    # the trainer joins a running stream, so it need not see a whole epoch
    _, trainer_complete = _check_served_epochs('png_served trainer', records, store_keys)
    trainer_hits = {k: v[3].extra['diagnostics'].get('serve_tenant_shared_decode_hits')
                    for k, v in runs.items()}
    frames = collections.Counter()
    for reader in readers:
        frames.update(reader._facade.frames)
    batches = {t['stream_id'] + ':' + tid: t['batches_served']
               for tid, t in stream['tenants'].items()}
    emit({'phase': 'serve_path', 'path': 'png_served', 'stream_ids': sorted(stream_ids),
          'workers': workers, 'ring_bytes': ring, 'trainer_blocks': len(records),
          'second_tenant_blocks': len(second['records']), 'common_seqs': len(common),
          'differing_blocks': len(differ), 'complete_epochs': {
              'trainer': trainer_complete, 'second_tenant': second_complete},
          'trainer_frames': dict(frames), 'second_tenant_frames': second['frames'],
          'second_tenant_rows_per_s': second['rows_per_s'],
          'second_tenant_rows': second['rows'], 'second_tenant_s': second['seconds'],
          'second_tenant_imported_torch': second['torch_imported'],
          'daemon_gpu_libraries': daemon_libs, 'daemon_shutdown_s': shutdown_s,
          'decoded_batches': stream['decoded_batches'],
          'dispatched': stream['fair_share'].get('dispatched'),
          'items_completed': stats['pool'].get('items_completed'),
          'tenants_batches_served': batches,
          'trainer_shared_decode_hits': trainer_hits,
          'evictions': stats['evictions']})
    if len(stream_ids) != 1:
        raise AssertionError('png_served: the tenants read {} streams'.format(len(stream_ids)))
    # the second tenant attached first and read until after the trainer
    # stopped: every block the trainer got, it got too, from the same decode
    if differ or len(common) != len(ours) or not all(trainer_hits.values()):
        raise AssertionError('png_served: of the trainer\'s {} blocks {} reached the second '
                             'tenant, {} differ; shared hits {}'.format(
                                 len(ours), len(common), len(differ), trainer_hits))
    if not second_complete:
        raise AssertionError('png_served: the second tenant completed no epoch')
    if not stream['decoded_batches'] <= stream['fair_share'].get('dispatched', 0):
        raise AssertionError('png_served: {} batches published for {} row groups '
                             'dispatched'.format(stream['decoded_batches'],
                                                 stream['fair_share'].get('dispatched')))
    if frames['blob'] != len(records) or frames['data'] or frames['cols'] \
            or second['frames']['blob'] != len(second['records']):
        raise AssertionError('png_served: blocks not by blob: {} {}'.format(
            dict(frames), second['frames']))
    if second['torch_imported'] or daemon_libs or stats['evictions']:
        raise AssertionError('png_served: torch in the second tenant {}, GPU libraries in the '
                             'daemon {}, evictions {}'.format(second['torch_imported'],
                                                              daemon_libs, stats['evictions']))

    def summary(result):
        return {'examples_per_sec': result.samples_per_second,
                'median_step_ms': result.extra['median_step_ms'],
                'input_stall_fraction': result.input_stall_fraction,
                'bottleneck': (result.extra['stall'] or {}).get('bottleneck')}

    emit({'phase': 'served_vs_png', 'png': {k: summary(v[3]) for k, v in png_runs.items()},
          'png_served': {k: summary(v[3]) for k, v in runs.items()},
          'second_tenant_rows_per_s': second['rows_per_s']})
    return total


def phase_serve_checks(raw_url, fixed_url, ring, work_dir):
    """``serve_checks``: the fixed-shape PNG store through a spawned daemon
    takes the fused blob route (``SERVE_COLS``) and its blocks equal the
    private fused read's; on a 64 KiB ring a tenant that never reads is
    evicted (``ConsumerEvictedError``) while the other reads every batch of
    the raw store's labels;
    a SIGKILLed daemon gives ``ServeDaemonDiedError``; the daemon exits on
    shutdown with no ``/dev/shm`` segment left."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.errors import ConsumerEvictedError, ServeDaemonDiedError
    from petastorm_tpu_torch.native import read_routes
    from petastorm_tpu_torch.serve import ReaderService

    workers = max(1, os.cpu_count() or 1)
    out = {'phase': 'serve_checks', 'ring_bytes': ring}

    def blocks_by_key(reader):
        keyed = {}
        for block in reader:
            keyed[json.dumps(block_key(block))] = block._asdict()
        return keyed

    # the fused blob route
    svc_dir = os.path.join(work_dir, 'svc_fixed')
    daemon = start_daemon(svc_dir, ring, workers)
    try:
        t0 = time.perf_counter()
        with make_reader(fixed_url, serve=svc_dir, output='columnar', shuffle_row_groups=False,
                         num_epochs=1) as reader:
            served = blocks_by_key(reader)
            frames = dict(reader._facade.frames)
        out['fused_served_s'] = time.perf_counter() - t0
        out['daemon_gpu_libraries'] = _mapped_gpu_libraries(daemon.pid)
    finally:
        out['daemon_shutdown_s'] = stop_daemon(daemon, svc_dir)
    before = read_routes.snapshot()
    with make_reader(fixed_url, output='columnar', shuffle_row_groups=False,
                     num_epochs=1) as reader:
        private = blocks_by_key(reader)
    routes = {k: v - before.get(k, 0) for k, v in read_routes.snapshot().items() if v - before.get(k, 0)}
    unequal = [k for k in private if k not in served or any(
        not np.array_equal(private[k][c], served[k][c]) for c in private[k])]
    out.update({'fused_blocks': len(served), 'fused_frames': frames,
                'private_read_routes': routes, 'fused_unequal_blocks': len(unequal)})
    if (unequal or len(served) != len(private) or frames['cols'] != len(served)
            or frames['blob'] or frames['data'] or out['daemon_gpu_libraries']
            or routes.get('fused_batches_total') != len(private)):
        raise AssertionError('serve_checks: the fused blob route: {}'.format(out))

    # eviction of a tenant that never reads, on a 64 KiB ring
    svc = ReaderService(os.path.join(work_dir, 'svc_evict'), workers_count=workers,
                        ring_bytes=SERVE_CHECK_RING, evict_block_s=SERVE_CHECK_EVICT_S,
                        idle_timeout_s=None)
    svc.start()
    try:
        kwargs = {'output': 'columnar', 'shuffle_row_groups': False,
                  'num_epochs': SERVE_CHECK_EPOCHS, 'schema_fields': ['label']}
        with make_reader(raw_url, serve=svc.service_dir, **kwargs) as fast, \
                make_reader(raw_url, serve=svc.service_dir, **kwargs) as slow:
            t0 = last = time.perf_counter()
            gaps, blocks = [], 0
            for _ in fast:
                now = time.perf_counter()
                gaps.append(now - last)
                last = now
                blocks += 1
            fast_s = time.perf_counter() - t0
            try:
                for _ in slow:
                    pass
                evicted = False
            except ConsumerEvictedError:
                evicted = True
            evictions = svc.stats()['evictions']
    finally:
        svc.shutdown()
    expected = SERVE_CHECK_EPOCHS * ROWS // ROWS_PER_ROW_GROUP
    out.update({'evict_ring_bytes': SERVE_CHECK_RING, 'evict_block_s': SERVE_CHECK_EVICT_S,
                'fast_blocks': blocks, 'fast_s': fast_s, 'fast_max_gap_s': max(gaps),
                'slow_evicted': evicted, 'evictions': evictions})
    if not evicted or evictions != 1 or blocks != expected:
        raise AssertionError('serve_checks: eviction: {}'.format(out))

    # a SIGKILLed daemon
    svc_dir = os.path.join(work_dir, 'svc_kill')
    reader = make_reader(raw_url, serve=svc_dir, output='columnar', num_epochs=None,
                         workers_count=2)
    pid = reader.daemon_pid
    try:
        for _, _block in zip(range(3), reader):
            pass
        os.kill(pid, signal.SIGKILL)
        t0 = time.perf_counter()
        try:
            while time.perf_counter() - t0 < 60:
                next(reader)
            died = None
        except ServeDaemonDiedError as e:
            died = repr(e)
        out['daemon_died_after_s'] = time.perf_counter() - t0
    finally:
        reader.stop()
        reader.join()
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
        # a SIGKILLed daemon cannot unlink its ring and blob dir
        leaked = _daemon_segments(pid)
        for entry in leaked:
            path = os.path.join('/dev/shm', entry)
            shutil.rmtree(path) if os.path.isdir(path) else os.unlink(path)
    out.update({'daemon_died': died, 'killed_daemon_segments_removed': leaked})
    emit(out)
    if died is None:
        raise AssertionError('serve_checks: no ServeDaemonDiedError after SIGKILL: {}'.format(out))


def phase_raw_mesh(torch, url):
    """``raw`` through the example's mesh flow
    (``jax_resnet_example.py:81-102``): ``make_mesh(('data',))`` (a world of
    one over NCCL, created here), ``shard_train_state``, the reader on
    ``reader_shard_for_process(mesh)`` and the batches staged onto
    ``data_sharding(mesh)``; eager, then graphed. At a world of one there is
    no DDP and no collective, so a fresh unsharded state from the seed,
    stepped with the same kind of step on the mesh run's first staged
    batches, must give its losses to the last bit. The process group is
    destroyed at the end. Returns the launches."""
    import torch.distributed as dist

    from petastorm_tpu_torch.models.train import make_train_step
    from petastorm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(('data',), device=DEVICE_TYPE)
    total = collections.Counter()
    try:
        for graphed in (False, True):
            launches, _, _, batches, _, losses = run_path(torch, 'raw_mesh', url, check_batch,
                                                          graphed=graphed, mesh=mesh)
            total.update(launches)
            state = new_train_state(torch)
            step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED,
                                   graphed=graphed)
            plain = [float(step(state, images, labels)[1]['loss']) for images, labels in batches]
            emit({'phase': 'mesh_vs_plain', 'path': 'raw_mesh',
                  'step': 'graphed' if graphed else 'eager', 'backend': dist.get_backend(),
                  'world_size': dist.get_world_size(), 'mesh_losses': losses[:len(plain)],
                  'plain_losses': plain, 'bit_equal': plain == losses[:len(plain)]})
            if plain != losses[:len(plain)]:
                raise AssertionError('raw_mesh ({}): the mesh step\'s losses {} are not the plain '
                                     'step\'s {} on the same batches'.format(
                                         'graphed' if graphed else 'eager',
                                         losses[:len(plain)], plain))
    finally:
        dist.destroy_process_group()
    return total


#: ``raw_elastic``'s pod (``bench_pod.py --chaos``): 1 s leases, the trainer
#: polling every 50 ms, host processes throttled to 2 ms a row, the kill 4
#: commits into the measured steps, a joiner right after it
ELASTIC_LEASE_S = 1.0
ELASTIC_POLL_S = 0.05
ELASTIC_SLEEP_PER_ROW = 0.002
ELASTIC_KILL_AFTER = 4
#: the host processes' epochs: more than they can read before they are
#: stopped after the trainer
ELASTIC_HOST_EPOCHS = 1000
ELASTIC_HOSTS = ('h1', 'h2')
ELASTIC_KILL, ELASTIC_JOIN = 'h1', 'h3'


def spawn_elastic_host(url, coord, host, out_dir):
    """One pod host: ``python -m petastorm_tpu_torch.elastic._hostproc``
    reading the store's labels (no torch, no device); its log and events go
    to ``out_dir``."""
    cmd = [sys.executable, '-m', 'petastorm_tpu_torch.elastic._hostproc', '--url', url,
           '--coord', coord, '--host', host, '--out', os.path.join(out_dir, host + '.jsonl'),
           '--field', 'label', '--seed', str(SEED), '--lease-s', str(ELASTIC_LEASE_S),
           '--sleep-per-row', str(ELASTIC_SLEEP_PER_ROW),
           '--num-epochs', str(ELASTIC_HOST_EPOCHS),
           '--ready-file', os.path.join(out_dir, host + '.ready')]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''))
    with open(os.path.join(out_dir, host + '.log'), 'ab') as log:
        return subprocess.Popen(cmd, stdout=log, stderr=log, env=env, cwd=ROOT)


def _host_log(out_dir, host):
    try:
        with open(os.path.join(out_dir, host + '.log')) as f:
            return f.read()[-3000:]
    except OSError:
        return ''


def _epoch_dir(coord, epoch):
    return os.path.join(coord, 'epochs', '{:06d}'.format(epoch))


def _done_markers(coord, epoch):
    try:
        return {int(n) for n in os.listdir(os.path.join(_epoch_dir(coord, epoch), 'done'))}
    except OSError:
        return set()


def _epochs(coord):
    try:
        return sorted(int(n) for n in os.listdir(os.path.join(coord, 'epochs')) if n.isdigit())
    except OSError:
        return []


def _kill_epoch_inflight(coord, host):
    """At the kill: the latest epoch holding ``host``'s in-flight file, the
    items in it and the done markers of that epoch."""
    for epoch in reversed(_epochs(coord)):
        path = os.path.join(_epoch_dir(coord, epoch), 'inflight', host + '.json')
        try:
            with open(path) as f:
                items = json.load(f).get('items') or []
        except (OSError, ValueError):
            continue
        return epoch, sorted(int(i) for i in items), _done_markers(coord, epoch)
    return None, [], set()


def pod_files(coord):
    """What a pod left in its coordination directory: the number of
    generation proposals (``<n>.json``, as the coordinator reads them), the
    lease files and the other files of ``members/``. A SIGKILL that lands
    between a lease renewal's write and its rename leaves the killed host's
    staged ``<host>.lease.tmp.<pid>``; no lease reader looks at it."""
    proposals = [n for n in os.listdir(os.path.join(coord, 'generations'))
                 if n.endswith('.json') and n.split('.')[0].isdigit()]
    members = sorted(os.listdir(os.path.join(coord, 'members')))
    leases = [n for n in members if n.endswith('.lease')]
    return len(proposals), leases, [n for n in members if n not in leases]


def check_elastic_pod(name, coord, items, kill):
    """The pod's scoreboard after a run: every commit's rank is its item's
    rank in ``global_order(items, SEED, epoch)``, no item of any epoch was
    committed twice, and every epoch that closed (all done markers present)
    has one commit record per marker; the kill's epoch closed, and the row
    groups the killed host held in flight and had not committed were
    committed by other hosts. Returns the summary of the line."""
    from petastorm_tpu_torch.elastic import global_order

    records = collections.defaultdict(list)
    commits_dir = os.path.join(coord, 'commits')
    for log_name in sorted(os.listdir(commits_dir)):
        with open(os.path.join(commits_dir, log_name)) as f:
            for line in f:
                rec = json.loads(line)
                records[(rec['epoch'], rec['item'])].append(rec)
    ranks = {}
    for (epoch, item), recs in sorted(records.items()):
        if len(recs) != 1:
            raise AssertionError('{}: epoch {} item {} committed {} times: {}'.format(
                name, epoch, item, len(recs), recs))
        if epoch not in ranks:
            ranks[epoch] = {it: r for r, it in enumerate(global_order(items, SEED, epoch))}
        if recs[0]['rank'] != ranks[epoch][item]:
            raise AssertionError('{}: epoch {} item {} committed at rank {}, global order {}'
                                 .format(name, epoch, item, recs[0]['rank'], ranks[epoch][item]))
    closed = []
    for epoch in _epochs(coord):
        markers = _done_markers(coord, epoch)
        if len(markers) == items:
            if markers != set(range(items)) or {i for e, i in records if e == epoch} != markers:
                raise AssertionError('{}: closed epoch {} has markers {} and commits {}'.format(
                    name, epoch, sorted(markers), sorted(i for e, i in records if e == epoch)))
            closed.append(epoch)
    if kill['epoch'] not in closed:
        raise AssertionError('{}: the kill\'s epoch {} did not close (closed: {})'.format(
            name, kill['epoch'], closed))
    pending = [i for i in kill['inflight'] if i not in kill['done']]
    adopters = {i: records[(kill['epoch'], i)][0]['host'] for i in pending}
    if any(host == ELASTIC_KILL for host in adopters.values()):
        raise AssertionError('{}: {} held {} in flight at the kill, committed by {}'.format(
            name, ELASTIC_KILL, pending, adopters))
    # the markers' mtimes against the kill's wall time: seconds until the
    # last of the killed host's in-flight row groups was committed
    done_dir = os.path.join(_epoch_dir(coord, kill['epoch']), 'done')
    handoff_s = (max(os.stat(os.path.join(done_dir, '{:08d}'.format(i))).st_mtime
                     for i in pending) - kill['wall'] if pending else None)
    shares = collections.Counter(recs[0]['host'] for recs in records.values())
    return {'closed_epochs': closed, 'commits': len(records),
            'host_commit_share': {h: shares[h] / len(records) for h in sorted(shares)},
            'kill_epoch': kill['epoch'], 'inflight_at_kill': kill['inflight'],
            'pending_at_kill': pending, 'adopted_by': adopters, 'handoff_s': handoff_s}


def phase_raw_elastic(torch, url, work_dir, raw_runs):
    """``raw_elastic``: the ``raw`` path's trainer as host ``h0`` of an
    elastic pod (``make_reader(elastic=ElasticConfig(host_id='h0',
    lease_s=1.0, poll_s=0.05), num_epochs=None)``) whose other hosts are
    host processes (``petastorm_tpu_torch.elastic._hostproc``, labels only,
    2 ms a row): ``h1`` and ``h2`` are up before the first step; when the
    measured steps begin a thread runs ``drive_host_churn``, which SIGKILLs
    ``h1`` once the pod has committed 4 more row groups and starts ``h3``;
    the last measured step waits for that if the buffered rows carried the
    steps past it, so the measured window always holds the churn. After the
    run the survivors are stopped (SIGTERM: they leave the pod).
    Eager, then graphed, each with a fresh coordination directory and pod.
    Checks: the kill and the join fell inside the measured steps, ``h3``
    committed before the survivors stopped, ``h1`` died of SIGKILL and the
    others exited 0, at least 3 generations, the
    trainer's ``elastic_ventilator_errors`` is 0, the scoreboard's
    exactly-once and global-order properties (:func:`check_elastic_pod`), no
    lease left but the killed host's (:func:`pod_files`: its staged renewal
    too, when the kill landed inside one), no process left. An ``elastic`` line
    per run and an ``elastic_vs_raw`` line beside ``raw``'s numbers of the
    same call. Returns the launches."""
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.elastic import ElasticConfig
    from petastorm_tpu_torch.faults import HostChurnPlan, count_committed, drive_host_churn

    total = collections.Counter()
    results = {}
    runs = {}
    for graphed in (False, True):
        kind = 'graphed' if graphed else 'eager'
        pod_dir = tempfile.mkdtemp(prefix='elastic_{}_'.format(kind), dir=work_dir)
        coord = os.path.join(pod_dir, 'coord')
        procs = {}
        churn = {}
        marks = {}
        try:
            t0 = time.perf_counter()
            for host in ELASTIC_HOSTS:
                procs[host] = spawn_elastic_host(url, coord, host, pod_dir)
            deadline = time.monotonic() + 120
            while not all(os.path.exists(os.path.join(pod_dir, h + '.ready'))
                          for h in ELASTIC_HOSTS):
                dead = {h: p.returncode for h, p in procs.items() if p.poll() is not None}
                if dead or time.monotonic() > deadline:
                    raise AssertionError('raw_elastic: hosts did not start ({}): {}'.format(
                        dead, {h: _host_log(pod_dir, h) for h in ELASTIC_HOSTS}))
                time.sleep(0.02)
            hosts_up_s = time.perf_counter() - t0

            def spawn_joiner():
                # right after the kill was reaped: the killed host's claims
                churn['wall'] = time.time()
                marks['kill'] = time.monotonic()
                churn['epoch'], churn['inflight'], churn['done'] = _kill_epoch_inflight(
                    coord, ELASTIC_KILL)
                return spawn_elastic_host(url, coord, ELASTIC_JOIN, pod_dir)

            churned = threading.Event()

            def drive(plan):
                try:
                    churn['timeline'] = drive_host_churn(coord, procs, plan,
                                                         spawn_joiner=spawn_joiner, timeout_s=60)
                except Exception as e:  # noqa: BLE001 - raised on the main thread below
                    churn['error'] = e
                finally:
                    churned.set()

            def on_step():
                steps = marks.setdefault('steps', 0) + 1
                marks['steps'] = steps
                if steps == WARMUP_STEPS:
                    # the measured steps begin: the churn starts 4 commits on
                    marks['measure'] = time.monotonic()
                    plan = HostChurnPlan(kill_host=ELASTIC_KILL, join_host=ELASTIC_JOIN,
                                         kill_after_commits=count_committed(coord)
                                         + ELASTIC_KILL_AFTER)
                    churn['plan'] = repr(plan)
                    churn['thread'] = threading.Thread(target=drive, args=(plan,), daemon=True,
                                                       name='chip-smoke-host-churn')
                    churn['thread'].start()
                elif steps == WARMUP_STEPS + STEPS:
                    # the measured window holds the kill and the join: the
                    # last step waits for them when the buffered rows carried
                    # the steps past the pod's 4 commits (the wait counts)
                    t_wait = time.monotonic()
                    churned.wait(timeout=60)
                    marks['last'] = time.monotonic()
                    marks['wait'] = marks['last'] - t_wait

            config = ElasticConfig(coord_dir=coord, host_id='h0', lease_s=ELASTIC_LEASE_S,
                                   poll_s=ELASTIC_POLL_S)
            launches, _, _, batches, result, losses = run_path(
                torch, 'raw_elastic', url, check_batch, graphed=graphed, on_step=on_step,
                reader_kwargs={'elastic': config})
            total.update(launches)
            runs[kind] = (batches, losses)
            registry = obs.get_registry()
            trainer = {k: registry.value(k) for k in (
                'elastic_commits', 'rowgroups_handed_off', 'elastic_lease_expirations',
                'reshard_generations', 'elastic_ventilator_errors', 'elastic_generation',
                'elastic_member_count')}
            churn['thread'].join(timeout=90)
            if churn['thread'].is_alive() or 'error' in churn:
                raise AssertionError('raw_elastic: the churn did not run: {}'.format(
                    churn.get('error')))
            if churn.get('epoch') is None:
                raise AssertionError('raw_elastic: {} held no epoch at the kill'.format(
                    ELASTIC_KILL))
            # the kill's epoch closes (the survivors adopt the killed host's
            # claims after its death is seen) before the survivors stop
            deadline = time.monotonic() + 60
            while len(_done_markers(coord, churn['epoch'])) < ROWS // ROWS_PER_ROW_GROUP:
                if time.monotonic() > deadline:
                    raise AssertionError('raw_elastic: the kill\'s epoch {} did not close: {}'
                                         .format(churn['epoch'], sorted(_done_markers(
                                             coord, churn['epoch']))))
                time.sleep(0.05)
            # the joiner takes its share (a commit of its own) before the
            # survivors stop; a host ends gracefully on SIGTERM once its
            # handler is in place, which is before its ready file
            live = [h for h, p in procs.items() if p.poll() is None]
            joiner_log = os.path.join(coord, 'commits', ELASTIC_JOIN + '.jsonl')
            while not (all(os.path.exists(os.path.join(pod_dir, h + '.ready')) for h in live)
                       and os.path.exists(joiner_log) and os.path.getsize(joiner_log)):
                if time.monotonic() > deadline:
                    raise AssertionError('raw_elastic: hosts {} never got ready or {} never '
                                         'committed: {}'.format(live, ELASTIC_JOIN, {
                                             h: _host_log(pod_dir, h) for h in live}))
                time.sleep(0.05)
            for host in live:
                procs[host].send_signal(signal.SIGTERM)
            rcs = {host: proc.wait(timeout=60) for host, proc in procs.items()}
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
        pod = check_elastic_pod('raw_elastic', coord, ROWS // ROWS_PER_ROW_GROUP, churn)
        generations, leases, staged = pod_files(coord)
        timeline = churn['timeline']
        during = marks['measure'] <= marks['kill'] <= marks['last']
        line = {'phase': 'elastic', 'path': 'raw_elastic', 'step': kind,
                'hosts_up_s': hosts_up_s, 'plan': churn['plan'],
                'commits_at_kill': timeline['commits_at_kill'],
                'killed': timeline['killed'], 'joined': timeline['joined'],
                'kill_s_into_measured_steps': marks['kill'] - marks['measure'],
                'measured_steps_s': marks['last'] - marks['measure'],
                'kill_during_measured_steps': during,
                'last_step_waited_for_churn_s': marks['wait'], 'return_codes': rcs,
                'generations': generations, 'leases_left': leases,
                'staged_leases_left': staged, 'trainer': trainer, **pod}
        emit(line)
        expected_rcs = {h: (-signal.SIGKILL if h == ELASTIC_KILL else 0) for h in rcs}
        killed_staged = '{}.lease.tmp.{}'.format(ELASTIC_KILL, procs[ELASTIC_KILL].pid)
        if (not during or rcs != expected_rcs or generations < 3
                or trainer['elastic_ventilator_errors'] or leases != [ELASTIC_KILL + '.lease']
                or set(staged) - {killed_staged}
                or timeline['killed'] != ELASTIC_KILL or timeline['joined'] != ELASTIC_JOIN):
            raise AssertionError('raw_elastic ({}): the churn checks failed: {} {}'.format(
                kind, line, {h: _host_log(pod_dir, h) for h in rcs}))
        results[kind] = result
        shutil.rmtree(pod_dir, ignore_errors=True)
    check_graphed_losses(torch, 'raw_elastic', runs['graphed'][1], runs['graphed'][0])
    check_no_leftovers()

    def numbers(result):
        return {'examples_per_sec': result.samples_per_second,
                'median_step_ms': result.extra['median_step_ms'],
                'input_stall_fraction': result.input_stall_fraction,
                'bottleneck': (result.extra['stall'] or {}).get('bottleneck')}

    emit({'phase': 'elastic_vs_raw',
          'raw': {k: numbers(v[3]) for k, v in raw_runs.items()},
          'raw_elastic': {k: numbers(v) for k, v in results.items()}})
    return total


#: the four-rank mesh check: the dry run's configuration on a (2, 2) mesh
MESH_RANKS = 4
MESH_SHAPE = (2, 2)
MESH_MODEL = {'stage_sizes': [2, 2, 2, 2], 'block': 'basic', 'num_classes': 16,
              'num_filters': 64}
MESH_IMAGE = 32
MESH_STEPS = 3
MESH_TOL = 1e-4
#: the mesh check's convolutions are PyTorch's own, not cuDNN's, on both
#: sides: cuDNN picks float32 algorithms by batch size (2 rows a rank, 4 in
#: the single process) whose rounding, through three SGD steps whose loss
#: doubles, reached 9.6e-5 of the 1e-4 on one batch order, against 1.8e-5
#: with PyTorch's convolutions on the same batches (PERF.md, section 6); the
#: paths train through cuDNN as before
MESH_CUDNN = False


def _state_err(actual, expected):
    """The worst leaf of two gathered states: ``(excess, name, max abs
    error, max abs value)``, where ``excess`` is the largest
    ``|a - e| - tol * |e|``: at most ``MESH_TOL`` when every value is within
    ``MESH_TOL`` absolute and relative."""
    if set(actual) != set(expected):
        raise AssertionError('states differ in names: {}'.format(set(actual) ^ set(expected)))
    return max((float(np.max(np.abs(actual[k] - expected[k]) - MESH_TOL * np.abs(expected[k]))),
                k, float(np.max(np.abs(actual[k] - expected[k]))),
                float(np.max(np.abs(expected[k])))) for k in expected)


def phase_mesh_checks(torch, url):
    """Four spawned ranks on the one card over gloo with CUDA tensors, a
    ``(2, 2)`` ``('data', 'model')`` mesh, the dry run's configuration
    (resnet18, 64 filters, 16 classes, 32x32, float32, TF32 off, 2 rows per
    data shard, the step's flip and normalize): each rank reads the store
    through its own reader shard and ``prefetch_to_device`` onto the data
    sharding and takes three sharded steps. This process then steps one
    model from the same seed on the global batches (each step's data shards
    in order): the losses, every parameter (the head gathered) and every
    batch statistic after steps 1 and 3 within 1e-4, the head's gradient
    after step 1 its slice on every rank, and the two ranks of each model
    group on identical batches; every rank's state is held to the single
    process's. Returns the ranks' normalize launches."""
    from petastorm_tpu_torch.entry import dryrun_preprocess
    from petastorm_tpu_torch.models.train import create_train_state, gather_state, make_train_step
    from petastorm_tpu_torch.parallel.launch import spawn
    from petastorm_tpu_torch.test_util import dist_workers

    spec = {'device': DEVICE_TYPE, 'axis_shapes': MESH_SHAPE, 'model': MESH_MODEL, 'seed': SEED,
            'url': url, 'global_batch': 2 * MESH_SHAPE[0], 'steps': MESH_STEPS,
            'record': (1, MESH_STEPS), 'flip_seed': SEED, 'preprocess': 'flip_normalize',
            'tf32': False, 'cudnn': MESH_CUDNN}
    t0 = time.perf_counter()
    ranks = spawn(dist_workers.sharded_steps, MESH_RANKS, (spec,), backend='gloo')
    spawn_s = time.perf_counter() - t0
    # one process, the global batch: the model ranks 0 of each data coordinate
    # hold the data shards, in data-coordinate order
    shards = [ranks[c * MESH_SHAPE[1]] for c in range(MESH_SHAPE[0])]
    if [r['coord'] for r in shards] != [(c, MESH_SHAPE[0]) for c in range(MESH_SHAPE[0])]:
        raise AssertionError('mesh_checks: data coordinates {}'.format([r['coord'] for r in ranks]))
    state = create_train_state(dist_workers.build_model(MESH_MODEL, seed=SEED),
                               device=DEVICE_TYPE)
    step = make_train_step(preprocess_fn=dryrun_preprocess, preprocess_seed=SEED)
    losses, errors, grad_errs = [], {}, []
    cudnn = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = MESH_CUDNN
    for i in range(1, MESH_STEPS + 1):
        images = torch.from_numpy(np.concatenate([r['batches'][i - 1][0] for r in shards]))
        labels = torch.from_numpy(np.concatenate([r['batches'][i - 1][1] for r in shards]))
        images, labels = images.to(DEVICE_TYPE), labels.to(DEVICE_TYPE)
        state, metrics = step(state, images, labels)
        losses.append(metrics['loss'].item())
        if i == 1:
            grad = state.model.head.weight.grad.cpu().numpy()
            for r in ranks:
                start, stop = r['head_grad_rows']
                grad_errs.append(float(np.abs(r['head_grad'] - grad[start:stop]).max()))
        if i in spec['record']:
            reference = gather_state(state)
            errors[i] = max(_state_err(r['states'][i], reference) for r in ranks)
    torch.backends.cudnn.enabled = cudnn
    loss_err = max(abs(a - b) for a, b in zip(ranks[0]['losses'], losses))
    groups = {}
    for r in ranks:
        groups.setdefault(r['coord'][0], set()).add(tuple(r['digests']))
    identical = all(len(d) == 1 for d in groups.values()) and len(groups) == MESH_SHAPE[0]
    # the replicated parameters of two model groups may differ in their last
    # bits: each group runs the body's backward itself, and cuDNN's weight
    # gradients need not be bit-reproducible; each rank is held to the
    # tolerance above, and how far the ranks drift apart is reported
    last = ranks[0]['states'][MESH_STEPS]
    drift = max(float(np.max(np.abs(r['states'][MESH_STEPS][k] - last[k])))
                for r in ranks for k in last)
    same_state = all(len({r['state_digests'][i] for r in ranks}) == 1 for i in spec['record'])
    launches = sum(r['launches']['normalize'] for r in ranks)
    emit({'phase': 'mesh_checks', 'ranks': MESH_RANKS, 'mesh': list(MESH_SHAPE),
          'backend': 'gloo', 'device': DEVICE_TYPE, 'cudnn': MESH_CUDNN, 'model': MESH_MODEL,
          'image_size': MESH_IMAGE,
          'global_batch': spec['global_batch'], 'steps': MESH_STEPS, 'spawn_s': spawn_s,
          'step_s': [r['step_s'] for r in ranks], 'losses': ranks[0]['losses'],
          'single_process_losses': losses, 'max_loss_err': loss_err,
          'state_worst_leaf': {i: {'excess_over_rtol': e[0], 'name': e[1], 'max_abs_err': e[2],
                                   'max_abs_value': e[3]} for i, e in errors.items()},
          'head_grad_max_err': grad_errs,
          'head': ranks[0]['head_type'], 'head_rows': ranks[0]['head_rows'],
          'model_groups_identical_batches': identical, 'ranks_bit_identical_state': same_state,
          'ranks_max_state_drift': drift,
          'tolerance': MESH_TOL, 'launches': launches})
    if not (loss_err <= MESH_TOL and max(e[0] for e in errors.values()) <= MESH_TOL
            and max(grad_errs) <= MESH_TOL and identical
            and ranks[0]['head_type'] == 'ColumnParallelHead'):
        raise AssertionError('mesh_checks: the sharded step is not the single-process step')
    return launches


def phase_entry_checks(torch):
    """``entry()``'s ResNet-50 bf16 forward on the card (its shape, dtype
    and finite values) and ``dryrun_multichip(1)`` over NCCL (all five
    legs: dp/tp, process pool, sp, ep and pp, none left unported). Returns
    the dry run's normalize launches."""
    from petastorm_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry(device=DEVICE_TYPE)
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(out).all())
    t0 = time.perf_counter()
    dry = dryrun_multichip(1, device=DEVICE_TYPE)
    emit({'phase': 'entry_checks', 'entry_shape': list(out.shape), 'entry_dtype': str(out.dtype),
          'entry_finite': finite, 'entry_forward_s': forward_s, 'dryrun': dry,
          'ep_loss': dry['ep_loss'], 'pp_err': dry['pp_err'],
          'dryrun_s': time.perf_counter() - t0})
    if tuple(out.shape) != (8, 1000) or out.dtype != torch.float32 or not finite:
        raise AssertionError('entry(): {} {} finite={}'.format(tuple(out.shape), out.dtype,
                                                               finite))
    if not (math.isfinite(dry['loss']) and math.isfinite(dry['process_loss'])
            and math.isfinite(dry['seq_loss']) and math.isfinite(dry['ep_loss'])
            and dry['pp_err'] < 1e-4
            and dry['legs_run'] == ['dp/tp', 'process pool', 'sp', 'ep', 'pp']
            and dry['legs_not_ported'] == {}):
        raise AssertionError('dryrun_multichip(1): {}'.format(dry))
    return dry['launches']['normalize']


class BlockSizes(object):
    """The reader a path's loader iterates, counting the rows of every block
    it hands over; every other attribute is the reader's."""

    def __init__(self, reader):
        self._reader = reader
        self.sizes = collections.Counter()

    def __iter__(self):
        return self

    def __next__(self):
        block = next(self._reader)
        self.sizes[len(block[0])] += 1
        return block

    def __getattr__(self, name):
        return getattr(self._reader, name)


def plain_batch_factory(readers):
    """``make_batch_reader`` behind a :class:`BlockSizes`, appended to
    ``readers``: the ``plain_batch`` path's reader factory."""
    def factory(url, **kwargs):
        from petastorm_tpu_torch import make_batch_reader

        reader = BlockSizes(make_batch_reader(url, **kwargs))
        readers.append(reader)
        return reader
    return factory


def check_plain_reader(reader):
    """``plain_batch``: every block the loader received had ``BATCH`` rows,
    and the schema was inferred from the plain store's Arrow schema."""
    schema = reader.schema
    if (set(reader.sizes) != {BATCH} or schema.name != 'inferred'
            or list(schema.fields) != ['image', 'label']):
        raise AssertionError('plain_batch: blocks of {} rows, schema {}'.format(
            dict(reader.sizes), schema))


def _row_keys(images, labels):
    """One key per row of a batch (host or card tensors, or numpy): its label
    and the crc32 of its image's bytes."""
    images = images.cpu().numpy() if hasattr(images, 'cpu') else np.asarray(images)
    labels = labels.cpu().numpy() if hasattr(labels, 'cpu') else np.asarray(labels)
    return [(int(label), zlib.crc32(image.tobytes())) for image, label in zip(images, labels)]


def store_row_keys():
    """The keys of the plain store's rows (the raw store's images and labels)."""
    return collections.Counter((i % NUM_CLASSES, zlib.crc32(_image(i).tobytes()))
                               for i in range(ROWS))


#: plain_resume: steps of the uninterrupted run, and the step after which the
#: interrupted run checkpoints
RESUME_STEPS = WARMUP_STEPS + STEPS
RESUME_AT = 5


def phase_plain_resume(torch, url, graphed):
    """``plain_resume``: the plain reader and loader on the dummy pool, with
    the loader's ``to_device`` and no prefetch queue, so the run is
    deterministic. :data:`RESUME_STEPS` steps uninterrupted; then the same
    from the seed for :data:`RESUME_AT` steps, the model's, the optimizer's
    and the loader's states through ``torch.save`` to bytes, the reader
    stopped, and a new model, optimizer, reader and loader from those states
    for the remaining steps. Each resumed batch must hold exactly the rows of
    the uninterrupted run's batch at that step: the loader's state keeps its
    buffered rows, not the buffer's blocks, so the rows of a batch may come
    in another order (the JAX loader's resume does the same); the step trains
    on them in the uninterrupted order, and its loss must be the
    uninterrupted one's within 1e-2 (bf16 convolutions need not be
    bit-reproducible). Returns the normalize launches and the first loss."""
    import io
    import pickle

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.models.train import make_train_step
    from petastorm_tpu_torch.ops.kernels import normalize as nk
    from petastorm_tpu_torch.torch import TorchDataLoader

    reader_kwargs = {'batch_size': BATCH, 'seed': SEED, 'shuffle_row_groups': True,
                     'num_epochs': None, 'reader_pool_type': 'dummy',
                     'transform_spec': plain_transform()}
    loader_kwargs = {'shuffling_queue_capacity': SHUFFLE_CAPACITY, 'seed': SEED,
                     'to_device': torch.device(DEVICE_TYPE)}

    def train(state, step, loader, count, order=None):
        keys, losses, same_order = [], [], 0
        it = iter(loader)
        for i in range(count):
            batch = next(it)
            images, labels = batch['image'], batch['label']
            row_keys = _row_keys(images, labels)
            if order is not None:
                if sorted(row_keys) != sorted(order[i]):
                    raise AssertionError('plain_resume: resumed batch {} holds other rows than '
                                         'the uninterrupted run\'s'.format(RESUME_AT + i))
                same_order += row_keys == order[i]
                perm = torch.tensor([row_keys.index(k) for k in order[i]], device=images.device)
                images, labels = images[perm], labels[perm]
                row_keys = list(order[i])
            keys.append(row_keys)
            losses.append(step(state, images, labels)[1]['loss'])
        return keys, [float(x) for x in losses], same_order

    nk.launches = 0
    with make_batch_reader(url, **reader_kwargs) as reader:
        state = new_train_state(torch)
        step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED, graphed=graphed)
        keys, losses, _ = train(state, step, TorchDataLoader(reader, BATCH, **loader_kwargs),
                                RESUME_STEPS)
    with make_batch_reader(url, **reader_kwargs) as reader:
        state = new_train_state(torch)
        step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED, graphed=graphed)
        loader = TorchDataLoader(reader, BATCH, **loader_kwargs)
        keys_a, losses_a, _ = train(state, step, loader, RESUME_AT)
        loader_state = loader.state_dict()
        state_bytes = len(pickle.dumps(loader_state))
        buf = io.BytesIO()
        torch.save({'model': state.model.state_dict(), 'optimizer': state.optimizer.state_dict(),
                    'step': state.step, 'loader': loader_state}, buf)
    del state, step, loader, loader_state
    ckpt = torch.load(io.BytesIO(buf.getvalue()), weights_only=False)
    state = new_train_state(torch)
    state.model.load_state_dict(ckpt['model'])
    state.optimizer.load_state_dict(ckpt['optimizer'])
    state.step = ckpt['step']
    step = make_train_step(preprocess_fn=preprocess, preprocess_seed=SEED, graphed=graphed)
    with make_batch_reader(url, resume_state=ckpt['loader']['reader'], **reader_kwargs) as reader:
        loader = TorchDataLoader(reader, BATCH, resume_state=ckpt['loader'], **loader_kwargs)
        keys_b, losses_b, same_order = train(state, step, loader, RESUME_STEPS - RESUME_AT,
                                             order=keys[RESUME_AT:])
    launches = {'normalize': nk.launches}
    resumed = losses_a + losses_b
    diffs = [abs(a - b) for a, b in zip(resumed, losses)]
    emit({'phase': 'path', 'path': 'plain_resume', 'step': 'graphed' if graphed else 'eager',
          'steps': RESUME_STEPS, 'resume_at': RESUME_AT, 'losses': losses,
          'resumed_losses': resumed, 'max_abs_loss_diff': max(diffs),
          'batches_equal_as_rows': RESUME_STEPS - RESUME_AT,
          'batches_in_the_same_row_order': same_order,
          'loader_state_pickled_bytes': state_bytes, 'checkpoint_bytes': len(buf.getvalue()),
          'launches': launches})
    if keys_a != keys[:RESUME_AT]:
        raise AssertionError('plain_resume: the run before the checkpoint is not deterministic')
    if not all(math.isfinite(x) for x in resumed) or abs(losses[0] - math.log(NUM_CLASSES)) > 1.0:
        raise AssertionError('plain_resume: losses {}'.format(losses))
    if max(diffs) > REPLAY_LOSS_TOL:
        raise AssertionError('plain_resume: resumed losses {} against {}'.format(resumed, losses))
    if launches['normalize'] < 2 * RESUME_STEPS:
        raise AssertionError('plain_resume: normalize launched {} times'.format(launches))
    return launches, losses[0]


def check_thread_epoch_once(url):
    """One epoch of the plain path on the thread pool, checkpointed at batch
    :data:`RESUME_AT` and resumed: the rows delivered before and after, as a
    multiset, are the epoch's rows, each exactly once."""
    import pickle

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.torch import TorchDataLoader

    kwargs = {'batch_size': BATCH, 'seed': SEED, 'shuffle_row_groups': True, 'num_epochs': 1,
              'workers_count': max(1, os.cpu_count() or 1), 'transform_spec': plain_transform()}
    loader_kwargs = {'shuffling_queue_capacity': SHUFFLE_CAPACITY, 'seed': SEED,
                     'drop_last': False}
    with make_batch_reader(url, **kwargs) as reader:
        loader = TorchDataLoader(reader, BATCH, **loader_kwargs)
        it = iter(loader)
        before = [k for batch in (next(it) for _ in range(RESUME_AT))
                  for k in _row_keys(batch['image'], batch['label'])]
        state = pickle.loads(pickle.dumps(loader.state_dict()))
    with make_batch_reader(url, resume_state=state['reader'], **kwargs) as resumed:
        after = [k for batch in TorchDataLoader(resumed, BATCH, resume_state=state, **loader_kwargs)
                 for k in _row_keys(batch['image'], batch['label'])]
    delivered = collections.Counter(before + after)
    ok = delivered == store_row_keys()
    out = {'checkpoint_at_batch': RESUME_AT, 'rows_before': len(before), 'rows_after': len(after),
           'rows_buffered_in_state': len(state['rows']), 'each_row_once': ok}
    if not ok:
        raise AssertionError('thread-pool epoch across a resume: {}'.format(out))
    return out


def phase_resume_checks(url, epoch_once):
    """``resume_checks``: a version-2 state merged from two shards restored
    on one reader reads every unfinished row group once; a state resumed by
    a reader over another item list is refused with the reference's error;
    a ``batch_size``/``drop_last`` state re-reads the rows the drop left
    undelivered. Rows are told apart by the crc32 of their PNG bytes."""
    from petastorm_tpu_torch import make_batch_reader, merge_resume_states

    def keys(reader, limit=None):
        out = []
        for n, block in enumerate(reader):
            out.extend(zlib.crc32(cell) for cell in block.image)
            if limit is not None and n + 1 >= limit:
                break
        return out

    base = {'reader_pool_type': 'dummy', 'seed': SEED, 'schema_fields': ['image']}
    with make_batch_reader(url, **base) as reader:
        every = keys(reader)
        finished = reader.state_dict()
    if len(set(every)) != ROWS:
        raise AssertionError('the plain store\'s PNG cells are not unique')
    first, states = [], []
    for shard in range(2):
        with make_batch_reader(url, cur_shard=shard, shard_count=2, **base) as reader:
            first.extend(keys(reader, limit=3 + shard))
            states.append(reader.state_dict())
    merged = merge_resume_states(states)
    with make_batch_reader(url, resume_state=merged, **base) as reader:
        rest = keys(reader)
    merged_ok = sorted(first + rest) == sorted(every)
    try:
        make_batch_reader(url, shuffle_row_drop_partitions=2, resume_state=finished, **base)
        refused = None
    except ValueError as e:
        refused = str(e)
    drop = dict(base, cur_shard=0, shard_count=3, batch_size=BATCH)
    with make_batch_reader(url, **drop) as reader:
        shard_rows = keys(reader)
    with make_batch_reader(url, drop_last=True, **drop) as reader:
        kept = keys(reader)
        drop_state = reader.state_dict()
    with make_batch_reader(url, resume_state=drop_state, **drop) as reader:
        reread = keys(reader)
    dropped = len(shard_rows) - len(kept)
    drop_ok = (dropped > 0 and len(kept) % BATCH == 0 and set(reread) <= set(shard_rows)
               and sorted(set(kept) | set(reread)) == sorted(shard_rows)
               and len(set(kept) & set(reread)) == 0)
    out = {'phase': 'resume_checks',
           'merged': {'shards': 2, 'rows_before': len(first), 'rows_after_merge': len(rest),
                      'remaining_row_groups': len(merged['remaining_global_parts']),
                      'each_row_once': merged_ok},
           'mismatch_refused': refused,
           'drop_last': {'shard_rows': len(shard_rows), 'kept': len(kept), 'dropped': dropped,
                         're_read_after_resume': len(reread), 'none_lost': drop_ok},
           'thread_pool_epoch': epoch_once}
    emit(out)
    if not (merged_ok and drop_ok and refused and 'does not match' in refused):
        raise AssertionError('resume checks failed: {}'.format(out))


# -- telemetry, the autotuner, ragged collation and the flight recorder ---------

#: the span ring of the spans-level runs: small enough that a path's run may
#: rotate it, so the bound is exercised
SPAN_RING_CAPACITY = 4096
#: the span names the spans-level runs must show between them (``read`` and
#: ``decode`` come from ``raw``'s page-scan route: ``png_fixed`` fuses both
#: of its columns, so it reads and decodes in ``fused_decode`` alone)
SPAN_NAMES = ('ventilate', 'read', 'fused_decode', 'pool_wait', 'shuffle.add_block',
              'shuffle.emit', 'collate', 'infeed')


def _tree_names(tree):
    names, stack = set(), list(tree['children'])
    while stack:
        node = stack.pop()
        names.add(node['name'])
        stack.extend(node['children'])
    return names


def _spans_summary(name, events, max_ring, top=1):
    """The spans of one run: names, traced batches, the trees that link the
    dispatch (``ventilate``) to the staging (``infeed``), the ring's most
    events against its capacity, and the slowest batch's breakdown."""
    from petastorm_tpu_torch import observability as obs

    trees = [obs.span_tree(events, t) for t in obs.traces_in(events)]
    linked = [t for t in trees if {'ventilate', 'infeed'} <= _tree_names(t)]
    slowest = obs.slowest_batches(events, top=top)
    busy = collections.Counter()
    for e in events:
        busy[e['name']] += e['dur']
    summary = {'path': name, 'events': len(events), 'names': sorted({e['name'] for e in events}),
               'busy_us_by_name': dict(busy.most_common()),
               'traced_batches': len(trees), 'ventilate_to_infeed_trees': len(linked),
               'ring_capacity': obs.get_ring().capacity, 'ring_max_events': max_ring,
               'ring_dropped': obs.get_ring().dropped,
               'slowest_batch': None if not slowest else {
                   'trace': slowest[0]['trace'], 'makespan_us': slowest[0]['makespan_us'],
                   'stage_breakdown_us': slowest[0]['stages'],
                   'critical_path': slowest[0]['critical_path']}}
    if not linked:
        raise AssertionError('{}: no batch\'s span tree links ventilate to infeed ({} trees)'
                             .format(name, len(trees)))
    if max_ring > summary['ring_capacity'] or len(events) > summary['ring_capacity']:
        raise AssertionError('{}: the span ring held {} events over its capacity {}'.format(
            name, max_ring, summary['ring_capacity']))
    return summary


def phase_telemetry_checks(torch, raw_url, fixed_url, process):
    """``raw`` graphed at each telemetry level and ``raw_process`` graphed
    at ``off`` and ``counters`` (``process``: its reader arguments), in one
    call (the cost of telemetry on the card's host; on the process pool,
    of each item's registry snapshot in its metrics frame), then
    ``png_fixed`` graphed at ``spans``:
    its Chrome trace under ``.torch_build/``, the span names of both spans
    runs, a span tree linking ``ventilate`` to ``infeed``, the ring within
    its capacity and the slowest batch's stage breakdown. Returns the
    launches."""
    from petastorm_tpu_torch import observability as obs

    total = collections.Counter()
    levels, spans = {'raw': {}, 'raw_process': {}}, {}
    for level, name, url in (('off', 'raw', raw_url), ('counters', 'raw', raw_url),
                             ('spans', 'raw', raw_url), ('off', 'raw_process', raw_url),
                             ('counters', 'raw_process', raw_url),
                             ('spans', 'png_fixed', fixed_url)):
        config = (obs.TelemetryConfig('spans', trace_capacity=SPAN_RING_CAPACITY)
                  if level == 'spans' else level)
        ring = {'max': 0}

        def on_step(ring=ring):
            ring['max'] = max(ring['max'], len(obs.get_ring()))

        launches, _, _, _, result, _ = run_path(
            torch, name, url, check_batch, graphed=True, telemetry=config,
            reader_kwargs=process if name == 'raw_process' else None, tag='telemetry_checks',
            on_step=on_step)
        total.update(launches)
        if name == 'raw_process':
            check_no_leftovers()
        if name in levels:
            levels[name][level] = {'examples_per_sec': result.samples_per_second,
                                   'input_stall_fraction': result.input_stall_fraction,
                                   'median_step_ms': result.extra['median_step_ms'],
                                   'stall': result.extra['stall']}
        if level == 'spans':
            events = obs.get_ring().snapshot()
            spans[name] = _spans_summary(name, events, max(ring['max'], len(events)))
            path = os.path.join(BUILD_DIR, 'trace_{}.json'.format(name))
            spans[name]['chrome_trace'] = os.path.relpath(path, ROOT)
            spans[name]['chrome_trace_events'] = obs.export_chrome_trace(path, events)
    obs.configure('counters')
    seen = set(spans['raw']['names']) | set(spans['png_fixed']['names'])
    missing = [n for n in SPAN_NAMES if n not in seen]
    fixed_names = set(spans['png_fixed']['names'])
    emit({'phase': 'telemetry_checks', 'levels': levels, 'spans': spans,
          'span_names_required': list(SPAN_NAMES), 'missing': missing,
          'cost_vs_off': {name: {level: {'examples_per_sec': v['examples_per_sec']
                                         / runs['off']['examples_per_sec'],
                                         'median_step_ms': v['median_step_ms']
                                         / runs['off']['median_step_ms']}
                                 for level, v in runs.items()}
                          for name, runs in levels.items()}})
    if missing or not {'fused_decode', 'ventilate', 'pool_wait', 'collate', 'infeed'} \
            <= fixed_names or fixed_names & {'read', 'decode'}:
        raise AssertionError('span names: missing {}; png_fixed has {}'.format(
            missing, sorted(fixed_names)))
    return total


def raw_row_groups():
    """The raw store's row groups by their label column (``i % 1000`` of
    rows ``i``: each row group's labels differ from every other's), as the
    rows each holds."""
    groups = {}
    for start in range(0, ROWS, ROWS_PER_ROW_GROUP):
        rows = range(start, min(start + ROWS_PER_ROW_GROUP, ROWS))
        groups[tuple(i % NUM_CLASSES for i in rows)] = rows
    if len(groups) * ROWS_PER_ROW_GROUP < ROWS:
        raise AssertionError('the raw store\'s label columns do not tell its row groups apart')
    return groups


class EpochRows(object):
    """The reader a path's loader iterates, recording the rows of every
    block (a raw row group, known by its label column: reading the 512-byte
    label column costs microseconds, where keying the images would put
    milliseconds into the loader's reader wait, which the autotuner reads)
    by the epoch of the item it came from (the ventilator's ``_seq`` over the
    items of an epoch), and the pool's worker count over time; every other
    attribute is the reader's."""

    def __init__(self, reader, items_per_epoch):
        self._reader = reader
        self._items_per_epoch = items_per_epoch
        self._groups = raw_row_groups()
        self.epochs = collections.defaultdict(collections.Counter)
        self.workers = []
        self._t0 = time.perf_counter()

    def __iter__(self):
        return self

    def __next__(self):
        block = next(self._reader)
        seq = self._reader._pool.last_result_seq
        self.epochs[seq // self._items_per_epoch].update(self._groups[tuple(block.label.tolist())])
        count = self._reader._pool.workers_count
        if not self.workers or self.workers[-1][1] != count:
            self.workers.append((round(time.perf_counter() - self._t0, 3), count))
        return block

    def __getattr__(self, name):
        return getattr(self._reader, name)


def check_epochs_once(name, epochs, keys):
    """Every epoch delivered each row at most once, and every epoch that
    delivered as many rows as the store holds delivered each row once."""
    complete = 0
    for epoch, counts in sorted(epochs.items()):
        if max(counts.values()) > 1 or set(counts) - set(keys):
            raise AssertionError('{}: epoch {} delivered a row twice or an unknown row'.format(
                name, epoch))
        if sum(counts.values()) == len(keys):
            complete += 1
            if counts != keys:
                raise AssertionError('{}: epoch {} is not the store\'s rows'.format(name, epoch))
    if not complete:
        raise AssertionError('{}: no epoch completed'.format(name))
    return complete


AUTOTUNE_STEPS = 60
AUTOTUNE_START_WORKERS = 2


def phase_autotune_checks(torch, raw_url, ring):
    """``raw_process`` graphed with the autotuner on (``interval_s=0.5``,
    workers 1 to the core count, starting at 2), for 3 + 60 steps, then the
    same on the thread pool: every decision (knob, action, before, after,
    bottleneck), the worker count over time, each epoch's rows once across
    every resize, no restart and no ``/dev/shm`` entry left. A decision is
    evidence, not a pass condition. Returns the launches."""
    from petastorm_tpu_torch import AutotuneConfig, make_reader
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups

    items = len(load_row_groups(raw_url))
    keys = collections.Counter(range(ROWS))
    total = collections.Counter()
    runs = {}
    for name, pool_kwargs in (('raw_process', {'reader_pool_type': 'process', 'zero_copy': True,
                                               'pool_kwargs': {'ring_bytes': ring,
                                                               'transport': 'shm'}}),
                              ('raw', {'reader_pool_type': 'thread'})):
        readers = []

        def factory(url, **kwargs):
            reader = EpochRows(make_reader(url, output='columnar', **kwargs), items)
            readers.append(reader)
            return reader

        config = AutotuneConfig(interval_s=0.5, min_workers=1, max_workers=os.cpu_count() or 1)
        kwargs = dict(pool_kwargs, autotune=config, workers_count=AUTOTUNE_START_WORKERS)
        launches, _, _, _, result, _ = run_path(
            torch, name, raw_url, check_batch, reader_kwargs=kwargs, graphed=True,
            steps=AUTOTUNE_STEPS, tag='autotune_checks', reader_factory=factory)
        total.update(launches)
        (reader,) = readers
        decisions = [{'knob': d['knob'], 'action': d['action'], 'from': d['from'],
                      'to': d['to'], 'bottleneck': d['window']['bottleneck'],
                      'wait_fraction': d['window']['reader_wait_fraction'],
                      'reason': d['reason']} for d in reader.autotuner.decision_records()]
        pool = result.extra['pool']
        runs[name] = {'pool': pool_kwargs['reader_pool_type'],
                      'start_workers': AUTOTUNE_START_WORKERS, 'max_workers': config.max_workers,
                      'decisions': decisions, 'workers_over_time_s': reader.workers,
                      'final_workers': pool['workers_count'],
                      'history_snapshots': len(reader.autotuner.history),
                      'examples_per_sec': result.samples_per_second,
                      'input_stall_fraction': result.input_stall_fraction,
                      'median_step_ms': result.extra['median_step_ms'],
                      'epochs_complete': check_epochs_once(name, reader.epochs, keys),
                      'epochs_seen': len(reader.epochs),
                      'worker_restarts': pool['worker_restarts'],
                      'items_requeued': pool['items_requeued']}
        if not decisions:
            runs[name]['note'] = 'no decision fired in this run'
        if pool['worker_restarts'] or pool['items_quarantined']:
            raise AssertionError('{} under the autotuner: {}'.format(name, pool))
        del readers, reader
        check_no_leftovers()
    emit({'phase': 'autotune_checks', 'interval_s': 0.5, 'steps': WARMUP_STEPS + AUTOTUNE_STEPS,
          'runs': runs})
    return total


TOKENS_ROWS = 4096
TOKENS_ROWS_PER_GROUP = 256
TOKENS_MAX_LEN = 256
TOKENS_SEED = 1234
TOKENS_PADDED_BATCH = 32
TOKENS_PAD_TO = 16
TOKENS_BUCKETS = (16, 32, 64, 128, 256)
TOKENS_PER_BATCH = 256
TOKENS_SLOTS = 8
TOKENS_POOL_ROWS = 512


def build_token_store(url):
    """``bench.py``'s token store: 4096 rows, 256 per row group, an int64 id
    and int32 tokens of ``min(zipf(1.6), 256)`` lengths, from a seed."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('TokensSchema', [
        UnischemaField('id', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('tokens', np.int32, (None,), NdarrayCodec(), False)])
    rng = np.random.default_rng(TOKENS_SEED)
    rows = []
    with materialize_dataset(url, schema, rows_per_row_group=TOKENS_ROWS_PER_GROUP) as writer:
        for i in range(TOKENS_ROWS):
            tokens = rng.integers(0, 32000, int(min(rng.zipf(1.6), TOKENS_MAX_LEN)),
                                  dtype=np.int32)
            writer.write({'id': np.int64(i), 'tokens': tokens})
            rows.append(tokens)
    return rows


def _staged_equal(staged, host):
    for name, value in host.items():
        got = staged[name]
        if hasattr(got, 'cpu'):
            if got.device.type != DEVICE_TYPE:
                raise AssertionError('{} staged on {}'.format(name, got.device))
            got = got.cpu().numpy()
        if not np.array_equal(got, value):
            raise AssertionError('a staged {} differs from its host collation'.format(name))


def _token_consumer(torch, url, kind, digest=None):
    """One pass of the token store through a consumer, each batch staged to
    the card through ``prefetch_to_device`` and held against its host
    collation. Returns the real tokens, the delivered sequences (by id, or
    as a multiset for packing), the rate and the consumer's waste or
    efficiency."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.sequence import CollateSpec, PackedSequenceLoader, PadSpec
    from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device

    hosts = collections.deque()
    delivered = collections.Counter() if kind == 'packed' else {}
    real = batches = 0
    t0 = time.perf_counter()
    with make_reader(url, reader_pool_type='dummy', shuffle_row_groups=True, seed=0) as reader:
        if kind == 'packed':
            consumer = PackedSequenceLoader(reader, tokens_per_batch=TOKENS_PER_BATCH,
                                            sequence_fields=['tokens'],
                                            slots_per_batch=TOKENS_SLOTS,
                                            pool_rows=TOKENS_POOL_ROWS)
        else:
            consumer = TorchDataLoader(
                reader, batch_size=TOKENS_PADDED_BATCH, drop_last=False,
                collate_spec=CollateSpec({'tokens': PadSpec(pad_to=TOKENS_PAD_TO)}),
                bucket_boundaries=TOKENS_BUCKETS if kind == 'bucketed' else None)

        def host_batches():
            for batch in consumer:
                hosts.append(batch)
                yield batch

        for staged in prefetch_to_device(host_batches(), torch.device(DEVICE_TYPE), size=2):
            host = hosts.popleft()
            _staged_equal(staged, host)
            batches += 1
            if kind == 'packed':
                seg, tokens = host['segment_ids'], host['tokens']
                real += int((seg > 0).sum())
                for slot in range(seg.shape[0]):
                    for s in range(1, int(host['num_segments'][slot]) + 1):
                        delivered[tokens[slot][seg[slot] == s].tobytes()] += 1
                if digest is not None:
                    digest.update(tokens.tobytes())
                    digest.update(seg.tobytes())
            else:
                real += int(host['tokens_lengths'].sum())
                for row_id, n, padded in zip(host['id'], host['tokens_lengths'],
                                             host['tokens']):
                    if int(row_id) in delivered:
                        raise AssertionError('{}: row {} delivered twice'.format(kind, row_id))
                    delivered[int(row_id)] = padded[:n].tobytes()
                    if padded[n:].any():
                        raise AssertionError('{}: nonzero padding'.format(kind))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        measure = (consumer.packing_efficiency if kind == 'packed'
                   else consumer.diagnostics['padding_waste_fraction'])
    return real, delivered, batches, seconds, measure


def phase_collate_checks(torch, work_dir):
    """The token store of ``bench.py`` under ``.torch_build/``, read (dummy
    pool, ``shuffle_row_groups=True``, seed 0) through the padded loader
    (``CollateSpec({'tokens': PadSpec(pad_to=16)})``, batch 32), the same
    with ``bucket_boundaries`` and ``PackedSequenceLoader(256 tokens, 8
    slots, 512 pooled rows)``, each staged to the card through
    ``prefetch_to_device``: each staged batch equals its host collation,
    every real token is delivered once, bucketing wastes less padding, and
    two same-seed packed runs are bit-exact."""
    import hashlib

    url = 'file://' + os.path.join(work_dir, 'tokens')
    t0 = time.perf_counter()
    rows = build_token_store(url)
    build_s = time.perf_counter() - t0
    total_real = sum(len(r) for r in rows)
    by_id = {i: r.tobytes() for i, r in enumerate(rows)}
    sequences = collections.Counter(by_id.values())
    out = {}
    for kind in ('padded', 'bucketed', 'packed'):
        digest = hashlib.sha256() if kind == 'packed' else None
        real, delivered, batches, seconds, measure = _token_consumer(torch, url, kind, digest)
        ok = real == total_real and (delivered == sequences if kind == 'packed'
                                     else delivered == by_id)
        out[kind] = {'batches': batches, 'real_tokens': real, 'seconds': seconds,
                     'real_tokens_per_s': real / seconds, 'every_token_once': ok,
                     ('packing_efficiency' if kind == 'packed'
                      else 'padding_waste_fraction'): measure}
        if not ok:
            raise AssertionError('{}: {} of {} real tokens, rows delivered as written: {}'.format(
                kind, real, total_real, ok))
        if digest is not None:
            again = hashlib.sha256()
            _token_consumer(torch, url, kind, again)
            out[kind]['bit_exact_rerun'] = digest.hexdigest() == again.hexdigest()
    emit({'phase': 'collate_checks', 'rows': TOKENS_ROWS, 'rows_per_row_group':
          TOKENS_ROWS_PER_GROUP, 'real_tokens': total_real, 'build_s': build_s, 'consumers': out})
    if not out['packed']['bit_exact_rerun']:
        raise AssertionError('two same-seed packed runs differ')
    if not out['bucketed']['padding_waste_fraction'] < out['padded']['padding_waste_fraction']:
        raise AssertionError('bucketing did not cut the padding waste: {} vs {}'.format(
            out['bucketed']['padding_waste_fraction'], out['padded']['padding_waste_fraction']))


FLIGHT_STEPS = 6


def flight_child(url, ring, run_dir):
    """The flight checks' child process: ``raw_process`` (eager, 3 + 6
    steps) with its flight files in ``run_dir``; after the warm-up it lists
    the files and prints them with the pids of this process and its workers
    as one JSON line. Called by :func:`phase_flight_checks`."""
    import torch

    from petastorm_tpu_torch import make_reader

    readers, seen = [], {}

    def factory(url, **kwargs):
        readers.append(make_reader(url, output='columnar', **kwargs))
        return readers[0]

    def on_step():
        if not seen:
            seen['files'] = sorted(f for f in os.listdir(run_dir) if f.endswith('.bin'))
            seen['consumer_pid'] = os.getpid()
            seen['worker_pids'] = sorted(p.pid for p in readers[0]._pool._processes
                                         if p is not None)

    kwargs = {'reader_pool_type': 'process', 'zero_copy': True,
              'pool_kwargs': {'ring_bytes': ring, 'transport': 'shm'}}
    run_path(torch, 'raw_process', url, check_batch, reader_kwargs=kwargs, steps=FLIGHT_STEPS,
             tag='flight_checks', reader_factory=factory, on_step=on_step)
    print(json.dumps({'flight_child': seen}), flush=True)


def phase_flight_checks(raw_url, ring):
    """A child process runs ``raw_process`` with ``PSTPU_FLIGHT_DIR`` inside
    ``.torch_build/``: while it runs, its own flight file and one per worker
    exist; after its clean exit, ``postmortem_report`` parses every file,
    names each process, finds the loader's closing stall record, and finds
    every process exited cleanly (no file of a process that died, was
    killed or is still running)."""
    from petastorm_tpu_torch.observability import blackbox

    run_dir = os.path.join(BUILD_DIR, 'flight', 'child')
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    env = dict(os.environ, PSTPU_FLIGHT_DIR=run_dir, PSTPU_FLIGHT_INTERVAL='0.2')
    env.pop('PSTPU_FLIGHT', None)
    code = 'import chip_smoke; chip_smoke.flight_child({!r}, {!r}, {!r})'.format(
        raw_url, ring, run_dir)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError('flight child exited {}: {}'.format(proc.returncode,
                                                                 proc.stderr[-3000:]))
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith('{')]
    seen = next(line['flight_child'] for line in lines if 'flight_child' in line)
    path_line = next(line for line in lines if line.get('phase') == 'path')
    report = blackbox.postmortem_report(run_dir)
    procs = {p['pid']: p for p in report['processes']}
    expected = [seen['consumer_pid']] + seen['worker_pids']
    during = {int(f.rsplit('-', 2)[-2]) for f in seen['files']}
    consumer = procs.get(seen['consumer_pid'])
    stale = [p for p in report['processes'] if p['status'] != 'exited']
    sidecars = [f for f in os.listdir(run_dir) if f.endswith('.crash')
                and os.path.getsize(os.path.join(run_dir, f))]
    out = {'phase': 'flight_checks', 'run_dir': os.path.relpath(run_dir, ROOT),
           'child_s': child_s, 'files_during_run': seen['files'],
           'processes': [{'label': p['label'], 'pid': p['pid'], 'status': p['status'],
                          'records': p['records_total'], 'torn': p['torn_records'],
                          'stall_record': p['last_stall_report'] is not None}
                         for p in report['processes']],
           'probable_cause': report['probable_cause'], 'skipped': report['skipped'],
           'stale': [p['path'] for p in stale], 'crash_sidecars': sidecars,
           'child_stall': path_line['stall'],
           'consumer_stall_record': None if consumer is None else consumer['last_stall_report']}
    emit(out)
    if not set(expected) <= during:
        raise AssertionError('flight files during the run: {} for processes {}'.format(
            seen['files'], expected))
    if (set(procs) != set(expected) or report['skipped'] or stale or sidecars
            or consumer is None or consumer['label'] != 'consumer'
            or consumer['last_stall_report'] is None
            or any(not procs[p]['label'].startswith('worker') for p in seen['worker_pids'])):
        raise AssertionError('post-mortem of the flight files: {}'.format(out))


#: the sequence paths: ``examples/sequence``'s telemetry store
#: (``generate_petastorm_sequence.py:13-33``: AR(1) features, ``sensor_id =
#: i % 8``, 256 rows per row group, seed 0) and its training flow
#: (``jax_sequence_example.py:39-80``: windows of 8, batch 16, 8 classes,
#: the default model: d_model 64, 4 heads, 2 layers, float32), with enough
#: rows that the measured steps do not repeat an epoch
SEQ_ROWS = 16384
SEQ_ROWS_PER_ROW_GROUP = 256
SEQ_FEATURES = 64
SEQ_WINDOW = 8
SEQ_BATCH = 16
SEQ_CLASSES = 8
SEQ_SEED = 0
#: the graphed sequence step against a fresh eager one on the same batches:
#: float32 with TF32 off, the replay runs the eager step's kernels
SEQ_GRAPH_TOL = 1e-5
#: the trained sequence model on the card against a float32 CPU copy of it
SEQ_MODEL_TOL = 1e-4
#: seq_checks: four gloo ranks on a (2, 2) ('data', 'seq') mesh at
#: bench_pod.py's sequence shape (windows of 4, 64 features, batch 16,
#: d_model 64, 2 layers), three steps each, against one process
SEQ_CHECK_RANKS = 4
SEQ_CHECK_SHAPE = (2, 2)
SEQ_CHECK_MODEL = {'num_classes': SEQ_CLASSES, 'seq_len': 4, 'feature_dim': SEQ_FEATURES,
                   'd_model': 64, 'num_heads': 4, 'num_layers': 2}
SEQ_CHECK_BATCH = 16
SEQ_CHECK_STEPS = 3
SEQ_CHECK_TOL = 1e-4
#: seq_moe: the same flow with ``MoESequenceTransformer``'s own widths
#: (``moe.py:133-136``: d_model 64, 4 heads, 2 layers, capacity factor
#: 1.25, d_hidden 4 x d_model) and 8 experts, the smallest expert count of
#: the Switch-Base scaling runs (arXiv:2101.03961); N = 16 x 8 = 128
#: tokens a layer, C = 20 slots an expert
SEQ_MOE_MODEL = {'num_classes': SEQ_CLASSES, 'num_experts': 8, 'seq_len': SEQ_WINDOW,
                 'feature_dim': SEQ_FEATURES, 'd_model': 64, 'num_heads': 4, 'num_layers': 2}
SEQ_MOE_CAPACITY = 20
#: moe_checks: four gloo ranks on (2, 2) and (1, 4) ('data', 'expert')
#: meshes, the seq_moe model, global batch 16, three steps, against one process
MOE_CHECK_RANKS = 4
MOE_CHECK_SHAPES = ((2, 2), (1, 4))
MOE_CHECK_STEPS = 3
MOE_CHECK_TOL = 1e-4
#: pp_checks: four gloo ranks on a ('stage',) mesh of 4, the dry run's gelu
#: stage at the telemetry features' width, 64 rows of the store in 8
#: microbatches, against the stages run one after another in this process
#: (the JAX test's tolerances, ``tests/test_ops.py:259-260,276``), with the
#: weights at the dry run's scale (0.3 at width 8) held variance-preserving
#: at width 64: 0.3 x sqrt(8 / 64). A second case takes the dry run's 0.3
#: itself, where four stages grow the gradients by orders of magnitude and
#: those absolute tolerances measure float32's rounding: it is held against
#: the stages run one after another in float64, within twice the float32
#: sequential run's own error (``dist_workers.float32_rounding_excess``)
PP_STAGES = 4
PP_MICROBATCHES = 8
PP_BATCH = 64
PP_REPEAT = 5
PP_TOL = 2e-5
PP_GRAD_RTOL, PP_GRAD_ATOL = 2e-4, 2e-5
PP_SCALE = 0.3 * math.sqrt(8 / 64)
PP_DRY_RUN_SCALE = 0.3


def build_seq_store(url):
    """The telemetry store, written by the port's ``materialize_dataset``:
    ``timestamp`` (int64), ``features`` (float32 x 64, AR(1) drift plus
    noise, the example's draws in its order) and ``sensor_id`` (int32,
    ``i % 8``). Returns the features as written."""
    from petastorm_tpu_torch.codecs import NdarrayCodec, ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('TelemetrySchema', [
        UnischemaField('timestamp', np.int64, (), ScalarCodec(), False),
        UnischemaField('features', np.float32, (SEQ_FEATURES,), NdarrayCodec(), False),
        UnischemaField('sensor_id', np.int32, (), ScalarCodec(), False)])
    rng = np.random.default_rng(SEQ_SEED)
    features = np.empty((SEQ_ROWS, SEQ_FEATURES), np.float32)
    state = rng.standard_normal(SEQ_FEATURES).astype(np.float32)
    with materialize_dataset(url, schema, rows_per_row_group=SEQ_ROWS_PER_ROW_GROUP) as writer:
        for i in range(SEQ_ROWS):
            state = 0.9 * state + 0.1 * rng.standard_normal(SEQ_FEATURES).astype(np.float32)
            features[i] = state + 0.05 * rng.standard_normal(SEQ_FEATURES).astype(np.float32)
            writer.write({'timestamp': i, 'features': features[i], 'sensor_id': i % 8})
    return features


def seq_ngram(window):
    """The example's NGram: ``timestamp``, ``features`` and ``sensor_id`` at
    every step of the window, consecutive timestamps only."""
    from petastorm_tpu_torch.ngram import NGram

    return NGram({i: ['timestamp', 'features', 'sensor_id'] for i in range(window)},
                 delta_threshold=1, timestamp_field='timestamp')


def seq_args(batch):
    """A staged nested window batch -> the step's ``(x, labels)`` and the
    window's timestamps: ``stack_ngram_time_axis`` on the card, labels
    ``sensor_id[:, 0] % 8``."""
    from petastorm_tpu_torch.torch import stack_ngram_time_axis

    stacked = stack_ngram_time_axis(batch)
    return (stacked['features'], (stacked['sensor_id'][:, 0] % SEQ_CLASSES).long(),
            stacked['timestamp'])


def check_seq_batch(x, timestamps, features):
    """A staged window batch holds the store's rows: consecutive timestamps
    within each window and each step's features as written."""
    ts = timestamps.cpu().numpy()
    if tuple(x.shape) != (SEQ_BATCH, SEQ_WINDOW, SEQ_FEATURES) or x.device.type != DEVICE_TYPE:
        raise AssertionError('staged windows: {} on {}'.format(tuple(x.shape), x.device))
    if not (np.diff(ts, axis=1) == 1).all() or not np.array_equal(x.cpu().numpy(), features[ts]):
        raise AssertionError('staged windows are not consecutive rows of the store')


def new_seq_state(torch, mesh, context):
    """A fresh example model from the seed on ``mesh``, sharded onto it."""
    from petastorm_tpu_torch.models import make_sequence_transformer
    from petastorm_tpu_torch.models.train import create_train_state, shard_train_state

    torch.manual_seed(SEED)
    model = make_sequence_transformer(SEQ_CLASSES, SEQ_WINDOW, SEQ_FEATURES, mesh=mesh,
                                      context_parallelism=context)
    return shard_train_state(create_train_state(model, device=DEVICE_TYPE), mesh)


def run_seq_path(torch, name, url, features, mesh, new_state, graphed, model_line):
    """One sequence path: a fresh model from the seed (``new_state()``), the
    example's reader (``make_reader(output='columnar', ngram=...,
    shuffle_row_groups=True, seed=0, num_epochs=None)``, default pool), a
    loader of batch 16 staged onto the mesh's data sharding,
    ``stack_ngram_time_axis`` on the card, 3 warm-up and 10 measured steps
    through ``pipeline_duty_cycle``; ``model_line`` describes the model on
    the path's line. Returns the state, the step, the first
    :data:`SAME_BATCHES` staged batches, the result, the losses and an MoE
    model's aux losses (else empty), and the last batch."""
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.models.train import make_train_step
    from petastorm_tpu_torch.parallel import data_sharding
    from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle

    state = new_state()
    train_step = make_train_step(graphed=graphed)
    losses, auxes, first_batches, last = [], [], [], []

    def step_fn(x, labels, timestamps):
        if not losses:
            check_seq_batch(x, timestamps, features)
        if len(first_batches) < SAME_BATCHES:
            first_batches.append((x, labels))
        last[:] = [x]
        _, metrics = train_step(state, x, labels)
        losses.append(metrics['loss'])
        if 'aux' in metrics:
            auxes.append(metrics['aux'])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.get_registry().reset()
    obs.get_ring().clear()
    t0 = time.perf_counter()
    result = pipeline_duty_cycle(
        url, step_fn, seq_args, batch_size=SEQ_BATCH, steps=STEPS, warmup_steps=WARMUP_STEPS,
        reader_kwargs={'ngram': seq_ngram(SEQ_WINDOW), 'output': 'columnar',
                       'shuffle_row_groups': True, 'seed': SEQ_SEED},
        loader_kwargs={'seed': SEQ_SEED}, telemetry='counters', to_device=data_sharding(mesh))
    wall_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    auxes = [float(x) for x in auxes]
    stall = result.extra['stall']
    line = {'phase': 'path', 'path': name, 'step': 'graphed' if graphed else 'eager'}
    line.update(model_line)
    line.update({
        'dtype': 'float32', 'd_model': 64, 'num_heads': 4, 'num_layers': 2, 'window': SEQ_WINDOW,
        'feature_dim': SEQ_FEATURES, 'num_classes': SEQ_CLASSES, 'batch_size': SEQ_BATCH,
        'rows': SEQ_ROWS, 'mesh': list(mesh.shape), 'warmup_steps': WARMUP_STEPS, 'steps': STEPS,
        'examples_per_sec': result.samples_per_second,
        'input_stall_fraction': result.input_stall_fraction,
        'median_step_ms': result.extra['median_step_ms'], 'step_ms': result.extra['step_ms'],
        'peak_memory_bytes': torch.cuda.max_memory_allocated(), 'losses': losses,
        'read_routes': result.extra['read_routes'], 'pool': result.extra['pool'],
        'stall': stall, 'wall_s': wall_s,
        'stage_s': {k[len('stage_'):-2]: v for k, v in sorted(result.extra['diagnostics'].items())
                    if k.startswith('stage_') and k.endswith('_s')}})
    if auxes:
        line['aux_losses'] = auxes
    emit(line)
    check_stall(name, stall)
    if len(losses) != WARMUP_STEPS + STEPS or not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError('{}: losses {}, aux losses {}'.format(name, losses, auxes))
    # a fresh model's logits are small: the first loss is close to log(classes)
    if abs(losses[0] - math.log(SEQ_CLASSES)) > 1.0:
        raise AssertionError('{}: first loss {} is far from log({})'.format(
            name, losses[0], SEQ_CLASSES))
    check_read_routes(name, result.extra['read_routes'])
    return state, train_step, first_batches, result, losses, auxes, last[0]


def check_seq_graphed_losses(torch, name, new_state, graphed_losses, batches):
    """A fresh eager state from the seed on the graphed run's first staged
    batches: its losses against the graphed run's, which replays the eager
    step's float32 kernels (within :data:`SEQ_GRAPH_TOL`; the line says
    whether they are equal to the last bit)."""
    from petastorm_tpu_torch.models.train import make_train_step

    state, step = new_state(), make_train_step()
    eager = [float(step(state, x, labels)[1]['loss']) for x, labels in batches]
    diffs = [abs(a - b) for a, b in zip(eager, graphed_losses)]
    emit({'phase': 'graph_check', 'path': name, 'eager_losses': eager,
          'graphed_losses': graphed_losses[:len(eager)], 'abs_diff': diffs,
          'bit_equal': eager == graphed_losses[:len(eager)], 'tolerance': SEQ_GRAPH_TOL})
    if max(diffs) > SEQ_GRAPH_TOL:
        raise AssertionError('{}: the graphed step\'s losses {} are not the eager step\'s {} on '
                             'the same batches'.format(name, graphed_losses[:len(eager)], eager))


def check_seq_model(torch, name, model, x):
    """The trained model on the card against a float32 copy of it on the
    CPU, on one staged batch."""
    import copy

    model.eval()
    with torch.no_grad():
        card, cpu = model(x), copy.deepcopy(model).cpu()(x.cpu())
        if isinstance(card, tuple):  # an MoE model: logits and aux loss
            card, cpu = torch.cat([card[0].flatten(), card[1][None]]), torch.cat(
                [cpu[0].flatten(), cpu[1][None]])
        card = card.cpu()
    model.train()
    err = float((card - cpu).abs().max())
    emit({'phase': 'model_check', 'path': name, 'max_abs_err': err,
          'max_abs_logit': float(cpu.abs().max()), 'tolerance': SEQ_MODEL_TOL,
          'finite': bool(torch.isfinite(card).all())})
    if not err <= SEQ_MODEL_TOL:
        raise AssertionError('{}: the model on the card is {} from float32 on the CPU'.format(
            name, err))


def phase_seq_paths(torch, url, features):
    """``seq_ring`` and ``seq_ulysses``: the example's flow on a
    ``('data', 'seq')`` mesh of a world of one over NCCL (created here,
    destroyed at the end), each with the eager and the graphed step; then a
    ``graph_check``, the device's idle share of each step kind (``profile``
    lines on a staged batch) and a ``model_check`` per path."""
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(('data', 'seq'), device=DEVICE_TYPE)
    try:
        for context in ('ring', 'ulysses'):
            name = 'seq_' + context
            new_state = functools.partial(new_seq_state, torch, mesh, context)
            runs = {}
            for graphed in (False, True):
                runs['graphed' if graphed else 'eager'] = run_seq_path(
                    torch, name, url, features, mesh, new_state, graphed,
                    {'model': 'sequence_transformer', 'context_parallelism': context})
            check_seq_model_paths(torch, name, new_state, runs)
    finally:
        dist.destroy_process_group()


def check_seq_model_paths(torch, name, new_state, runs):
    """After a sequence path's eager and graphed runs: the ``graph_check``,
    a ``profile`` line per step kind on the eager run's first staged batch,
    and the ``model_check``."""
    check_seq_graphed_losses(torch, name, new_state, runs['graphed'][4], runs['graphed'][2])
    x, labels = runs['eager'][2][0]
    for kind, run in runs.items():
        _profile_step(torch, kind, run[0], run[1], x, labels,
                      run[3].extra['median_step_ms'], path=name)
    check_seq_model(torch, name, runs['eager'][0].module, x)


def new_moe_state(torch, mesh):
    """A fresh ``seq_moe`` model from the seed on ``mesh``, sharded onto it."""
    from petastorm_tpu_torch.models import MoESequenceTransformer
    from petastorm_tpu_torch.models.train import create_train_state, shard_train_state

    torch.manual_seed(SEED)
    model = MoESequenceTransformer(mesh=mesh, **SEQ_MOE_MODEL)
    return shard_train_state(create_train_state(model, device=DEVICE_TYPE), mesh)


def phase_seq_moe(torch, url, features):
    """``seq_moe``: the sequence paths' flow with the MoE sequence
    transformer (8 experts) on a ``('data', 'expert')`` mesh of a world of
    one over NCCL, stepped on ``moe_loss``, eager and graphed; each line
    adds the aux loss of every step and, computed outside the step on the
    last batch, each layer's expert loads and dropped-token fraction. Then
    the ``graph_check``, ``profile`` and ``model_check`` lines."""
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel import make_mesh

    name = 'seq_moe'
    mesh = make_mesh(('data', 'expert'), device=DEVICE_TYPE)
    try:
        new_state = functools.partial(new_moe_state, torch, mesh)
        runs = {}
        for graphed in (False, True):
            kind = 'graphed' if graphed else 'eager'
            runs[kind] = run_seq_path(
                torch, name, url, features, mesh, new_state, graphed,
                {'model': 'moe_sequence_transformer', 'num_experts': SEQ_MOE_MODEL['num_experts'],
                 'capacity_factor': 1.25, 'capacity': SEQ_MOE_CAPACITY, 'loss': 'moe_loss'})
            routing = runs[kind][0].module.routing_stats(runs[kind][6])
            emit({'phase': 'routing', 'path': name, 'step': kind, 'batch': 'last',
                  'layers': routing})
            if any(layer['capacity'] != SEQ_MOE_CAPACITY
                   or sum(layer['expert_load']) != SEQ_BATCH * SEQ_WINDOW for layer in routing):
                raise AssertionError('{}: routing {}'.format(name, routing))
        check_seq_model_paths(torch, name, new_state, runs)
    finally:
        dist.destroy_process_group()


def phase_seq_checks(torch, url):
    """Four spawned ranks on the one card over gloo with CUDA tensors (NCCL
    refuses two ranks on one card; the ring's and Ulysses' exchanges go
    through the host on gloo), a ``(2, 2)`` ``('data', 'seq')`` mesh at
    ``bench_pod.py``'s shape: ring and Ulysses, causal and not, three steps
    each; each rank reads its data coordinate's shard of the telemetry
    store's windows of 4 through a 2-worker thread pool, stages its
    ``[B/2, T/2, F]`` slice onto the sequence sharding, and steps. This
    process steps one model from the same seed with plain (causal: one-rank
    ring) attention on the global batches the ranks trained on: the losses
    and every parameter after step 3 within 1e-4, and the two ranks of each
    seq group on the same labels."""
    from petastorm_tpu_torch.models.train import create_train_state, gather_state, make_train_step
    from petastorm_tpu_torch.parallel.launch import spawn
    from petastorm_tpu_torch.test_util import dist_workers

    runs = [(context, causal) for context in ('ring', 'ulysses') for causal in (False, True)]
    specs = [{'device': DEVICE_TYPE, 'axis_shapes': SEQ_CHECK_SHAPE, 'model': SEQ_CHECK_MODEL,
              'seed': SEED, 'context': context, 'causal': causal, 'url': url,
              'ngram_fields': ('timestamp', 'features', 'sensor_id'),
              'timestamp_field': 'timestamp', 'delta_threshold': 1, 'feature_field': 'features',
              'label_field': 'sensor_id', 'reader_seed': SEQ_SEED,
              'global_batch': SEQ_CHECK_BATCH, 'steps': SEQ_CHECK_STEPS,
              'record': (SEQ_CHECK_STEPS,), 'shard': True} for context, causal in runs]
    t0 = time.perf_counter()
    ranks = spawn(dist_workers.several_sequence_runs, SEQ_CHECK_RANKS, (specs,), backend='gloo')
    spawn_s = time.perf_counter() - t0
    lines = []
    for i, (context, causal) in enumerate(runs):
        by_coord = {r[i]['coord'][:3:2]: r[i] for r in ranks}
        same_labels = all(np.array_equal(by_coord[(d, 0)]['labels'][s],
                                         by_coord[(d, 1)]['labels'][s])
                          for d in range(2) for s in range(SEQ_CHECK_STEPS))
        state = create_train_state(dist_workers.build_sequence_model(
            SEQ_CHECK_MODEL, seed=SEED, causal=causal), device=DEVICE_TYPE)
        step = make_train_step()
        losses = []
        for s in range(SEQ_CHECK_STEPS):
            x = np.concatenate([np.concatenate([by_coord[(d, q)]['slices'][s] for q in range(2)],
                                               axis=1) for d in range(2)])
            y = np.concatenate([by_coord[(d, 0)]['labels'][s] for d in range(2)])
            state, metrics = step(state, torch.from_numpy(x).to(DEVICE_TYPE),
                                  torch.from_numpy(y).to(DEVICE_TYPE))
            losses.append(metrics['loss'].item())
        reference = gather_state(state)
        loss_err = max(abs(a - b) for r in ranks for a, b in zip(r[i]['losses'], losses))
        state_err = max(float(np.max(np.abs(r[i]['states'][SEQ_CHECK_STEPS][k] - reference[k])))
                        for r in ranks for k in reference)
        lines.append({'context': context, 'causal': causal, 'losses': ranks[0][i]['losses'],
                      'single_process_losses': losses, 'max_loss_err': loss_err,
                      'max_state_err': state_err, 'seq_groups_same_labels': same_labels,
                      'step_s': [r[i]['step_s'] for r in ranks]})
    emit({'phase': 'seq_checks', 'ranks': SEQ_CHECK_RANKS, 'mesh': list(SEQ_CHECK_SHAPE),
          'backend': 'gloo', 'device': DEVICE_TYPE, 'model': SEQ_CHECK_MODEL,
          'global_batch': SEQ_CHECK_BATCH, 'steps': SEQ_CHECK_STEPS, 'spawn_s': spawn_s,
          'runs': lines, 'tolerance': SEQ_CHECK_TOL})
    for line in lines:
        if not (line['max_loss_err'] <= SEQ_CHECK_TOL and line['max_state_err'] <= SEQ_CHECK_TOL
                and line['seq_groups_same_labels']
                and all(math.isfinite(x) for x in line['losses'])):
            raise AssertionError('seq_checks ({context}, causal={causal}): the sharded step is not '
                                 'the single-process step'.format(**line))


def phase_moe_pp_checks(torch, url):
    """``moe_checks`` and ``pp_checks`` in one spawn of four ranks on the one
    card over gloo with CUDA tensors (the ranks' start-up paid once)."""
    from petastorm_tpu_torch.parallel.launch import spawn
    from petastorm_tpu_torch.test_util import dist_workers

    specs = [{'device': DEVICE_TYPE, 'axis_shapes': shape, 'model': SEQ_MOE_MODEL, 'seed': SEED,
              'url': url, 'ngram_fields': ('timestamp', 'features', 'sensor_id'),
              'timestamp_field': 'timestamp', 'delta_threshold': 1, 'feature_field': 'features',
              'label_field': 'sensor_id', 'reader_seed': SEQ_SEED, 'global_batch': SEQ_BATCH,
              'steps': MOE_CHECK_STEPS, 'record': (MOE_CHECK_STEPS,), 'shard': True}
             for shape in MOE_CHECK_SHAPES]
    rng = np.random.default_rng(SEED)
    normal = rng.standard_normal((PP_STAGES, SEQ_FEATURES, SEQ_FEATURES))
    b = (rng.standard_normal((PP_STAGES, SEQ_FEATURES)) * 0.1).astype(np.float32)
    ws = [(normal * scale).astype(np.float32) for scale in (PP_SCALE, PP_DRY_RUN_SCALE)]
    cases = [{'device': DEVICE_TYPE, 'microbatches': PP_MICROBATCHES, 'w': w, 'b': b, 'url': url,
              'global_batch': PP_BATCH, 'field': 'features', 'repeat': repeat}
             for w, repeat in zip(ws, (PP_REPEAT, 1))]
    t0 = time.perf_counter()
    ranks = spawn(dist_workers.moe_and_pipeline_runs, MOE_CHECK_RANKS, (specs, cases),
                  backend='gloo')
    spawn_s = time.perf_counter() - t0
    check_moe_runs(torch, [moe for moe, _ in ranks], spawn_s)
    check_pipeline_runs(torch, [pp for _, pp in ranks], ws, b, spawn_s)


def check_moe_runs(torch, ranks, spawn_s):
    """``moe_checks``: each rank's runs on ``(2, 2)`` and ``(1, 4)``
    ``('data', 'expert')`` meshes of the ``seq_moe`` model from the seed,
    experts sharded over the expert group, each rank reading its data
    coordinate's shard of the telemetry store's windows of 8 through a
    2-worker thread pool, global batch 16, three steps on ``moe_loss``.
    This process steps one model from the same seed on the global batches
    the ranks trained on: the losses, the aux losses and every parameter
    after step 3 (the experts gathered) within 1e-4, and the ranks of each
    expert group on the same rows."""
    from petastorm_tpu_torch.models.train import create_train_state, gather_state, make_train_step
    from petastorm_tpu_torch.test_util import dist_workers

    lines = []
    for i, shape in enumerate(MOE_CHECK_SHAPES):
        by_coord = {r[i]['coord'][::2]: r[i] for r in ranks}
        same_rows = all(np.array_equal(by_coord[(d, 0)]['slices'][s], by_coord[(d, e)]['slices'][s])
                        for d in range(shape[0]) for e in range(shape[1])
                        for s in range(MOE_CHECK_STEPS))
        state = create_train_state(dist_workers.build_moe_model(SEQ_MOE_MODEL, seed=SEED),
                                   device=DEVICE_TYPE)
        step = make_train_step()
        losses, auxes = [], []
        for s in range(MOE_CHECK_STEPS):
            x = np.concatenate([by_coord[(d, 0)]['slices'][s] for d in range(shape[0])])
            y = np.concatenate([by_coord[(d, 0)]['labels'][s] for d in range(shape[0])])
            state, metrics = step(state, torch.from_numpy(x).to(DEVICE_TYPE),
                                  torch.from_numpy(y).to(DEVICE_TYPE))
            losses.append(metrics['loss'].item())
            auxes.append(metrics['aux'].item())
        reference = gather_state(state)
        loss_err = max(abs(a - b) for r in ranks
                       for a, b in zip(r[i]['losses'] + r[i]['auxes'], losses + auxes))
        state_err = max(float(np.max(np.abs(r[i]['states'][MOE_CHECK_STEPS][k] - reference[k])))
                        for r in ranks for k in reference)
        lines.append({'mesh': list(shape), 'losses': ranks[0][i]['losses'],
                      'aux_losses': ranks[0][i]['auxes'], 'single_process_losses': losses,
                      'single_process_aux_losses': auxes, 'max_loss_err': loss_err,
                      'max_state_err': state_err, 'expert_groups_same_rows': same_rows,
                      'reader_shards': sorted({tuple(r[i]['reader_shard']) for r in ranks}),
                      'routing_last_batch': ranks[0][i]['routing'],
                      'step_s': [r[i]['step_s'] for r in ranks]})
    emit({'phase': 'moe_checks', 'ranks': MOE_CHECK_RANKS, 'backend': 'gloo',
          'device': DEVICE_TYPE, 'model': SEQ_MOE_MODEL, 'global_batch': SEQ_BATCH,
          'steps': MOE_CHECK_STEPS, 'spawn_with_pp_checks_s': spawn_s, 'runs': lines,
          'max_err': max(max(line['max_loss_err'], line['max_state_err']) for line in lines),
          'tolerance': MOE_CHECK_TOL})
    for line in lines:
        if not (line['max_loss_err'] <= MOE_CHECK_TOL and line['max_state_err'] <= MOE_CHECK_TOL
                and line['expert_groups_same_rows']
                and all(math.isfinite(x) for x in line['losses'] + line['aux_losses'])):
            raise AssertionError('moe_checks ({}): the sharded step is not the single-process '
                                 'step'.format(line['mesh']))


def _pipeline_witness(torch, ranks, w, b):
    """The float64 witness of ``pp_checks`` at the dry run's weight scale:
    the pipeline's largest errors (output, stacked gradients) against the
    stages run one after another in float64 on the card, the float32
    sequential run's own, and ``float32_rounding_excess`` of each."""
    from petastorm_tpu_torch.test_util.dist_workers import (float32_rounding_excess,
                                                            sequential_stages)

    x = ranks[0]['x']
    exact = sequential_stages(w, b, x, torch.float64, DEVICE_TYPE)
    plain = sequential_stages(w, b, x, torch.float32, DEVICE_TYPE)
    by_stage = sorted(ranks, key=lambda r: r['stage'])
    ours = (by_stage[0]['y'], np.stack([r['w_grad'] for r in by_stage]),
            np.stack([r['b_grad'] for r in by_stage]))
    out = {'weight_scale': PP_DRY_RUN_SCALE, 'max_abs_y': float(np.abs(exact[0]).max()),
           'max_abs_grad': float(np.abs(exact[1]).max()),
           'same_input': all(np.array_equal(r['x'], x) for r in ranks)}
    for name, o, p, e in zip(('y', 'w_grad', 'b_grad'), ours, plain, exact):
        out[name] = {'pipeline_err_vs_f64': float(np.abs(o - e).max()),
                     'sequential_f32_err_vs_f64': float(np.abs(p - e).max()),
                     'pipeline_err_vs_sequential_f32': float(np.abs(o - p).max()),
                     'rounding_excess': float32_rounding_excess(o, p, e)}
    return out


def check_pipeline_runs(torch, ranks, ws, b, spawn_s):
    """``pp_checks``: each rank's stage of a ``('stage',)`` mesh of 4 (the
    shifts through host memory on gloo): the dry run's stage ``gelu(act @ w
    + b)`` at the telemetry features' width (64) with stacked parameters
    ``ws[0]``, ``b`` from the seed (``w`` scaled 0.3 x sqrt(8 / 64)), a
    global batch of 64 rows of the store's ``features`` read through a
    2-worker thread pool and staged onto ``data_sharding(mesh,
    batch_axes=())`` (rank 0's rows on every stage), 8 microbatches. The
    output against the stages run one after another in this process
    (2e-5), the gradients of ``sum(y**2)`` (rtol 2e-4, atol 2e-5), each
    rank's seconds per forward and per forward + backward over 5 runs, and
    the bubble fraction ``(S-1)/(S+M-1)``. Then the same with ``ws[1]``
    (the same draws at the dry run's 0.3) against float64
    (:func:`_pipeline_witness`)."""
    from petastorm_tpu_torch.entry import gelu_stage

    witness = _pipeline_witness(torch, [r[1] for r in ranks], ws[1], b)
    ranks = [r[0] for r in ranks]
    wt = torch.from_numpy(ws[0]).to(DEVICE_TYPE).requires_grad_()
    bt = torch.from_numpy(b).to(DEVICE_TYPE).requires_grad_()
    x = torch.from_numpy(ranks[0]['x']).to(DEVICE_TYPE)
    ref = x
    for stage in range(PP_STAGES):
        ref = gelu_stage((wt[stage], bt[stage]), ref)
    (ref ** 2).sum().backward()
    ref, w_grad, b_grad = ref.detach().cpu().numpy(), wt.grad.cpu().numpy(), bt.grad.cpu().numpy()
    same_input = all(np.array_equal(r['x'], ranks[0]['x']) for r in ranks)
    err = max(float(np.abs(r['y'] - ref).max()) for r in ranks)
    grad_excess = max(float(np.max(np.abs(ours - theirs) - (PP_GRAD_ATOL + PP_GRAD_RTOL
                                                              * np.abs(theirs))))
                      for r in ranks for ours, theirs in ((r['w_grad'], w_grad[r['stage']]),
                                                          (r['b_grad'], b_grad[r['stage']])))
    grad_err = max(float(np.abs(ours - theirs).max())
                   for r in ranks for ours, theirs in ((r['w_grad'], w_grad[r['stage']]),
                                                       (r['b_grad'], b_grad[r['stage']])))
    emit({'phase': 'pp_checks', 'ranks': PP_STAGES, 'backend': 'gloo', 'device': DEVICE_TYPE,
          'stages': PP_STAGES, 'microbatches': PP_MICROBATCHES, 'batch': PP_BATCH,
          'width': SEQ_FEATURES, 'spawn_with_moe_checks_s': spawn_s,
          'bubble_fraction': (PP_STAGES - 1) / (PP_STAGES + PP_MICROBATCHES - 1),
          'weight_scale': PP_SCALE, 'max_abs_y': float(np.abs(ref).max()),
          'max_abs_grad': float(np.abs(w_grad).max()),
          'max_abs_err': err, 'tolerance': PP_TOL, 'max_grad_abs_err': grad_err,
          'grad_tolerance': {'rtol': PP_GRAD_RTOL, 'atol': PP_GRAD_ATOL},
          'stages_same_input': same_input,
          'other_stage_rows_zero': all(r['other_rows_zero'] for r in ranks),
          'forward_s': [r['forward_s'] for r in ranks],
          'forward_backward_s': [r['forward_backward_s'] for r in ranks],
          'median_forward_s': statistics.median(t for r in ranks for t in r['forward_s'][1:]),
          'median_forward_backward_s': statistics.median(
              t for r in ranks for t in r['forward_backward_s'][1:]),
          'dry_run_scale': witness})
    if not (err <= PP_TOL and grad_excess <= 0 and same_input
            and all(r['other_rows_zero'] for r in ranks)):
        raise AssertionError('pp_checks: the pipeline is not the stages run one after another '
                             '(output {}, gradients {})'.format(err, grad_err))
    if not (witness['same_input'] and all(witness[name]['rounding_excess'] <= 0
                                          for name in ('y', 'w_grad', 'b_grad'))):
        raise AssertionError('pp_checks: at the dry run scale the pipeline is further from '
                             'float64 than float32 rounding: {}'.format(witness))


def _all_windows(url, **kwargs):
    """Every window of one epoch of the telemetry store (windows of
    :data:`SEQ_WINDOW`), as ``{field: [W, T, ...]}`` sorted by the first
    timestamp, and the read's seconds."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.torch import stack_ngram_time_axis

    t0 = time.perf_counter()
    with make_reader(url, output='columnar', ngram=seq_ngram(SEQ_WINDOW), num_epochs=1,
                     seed=SEQ_SEED, **kwargs) as reader:
        blocks = [stack_ngram_time_axis(block) for block in reader]
    seconds = time.perf_counter() - t0
    windows = {k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]}
    order = np.argsort(windows['timestamp'][:, 0], kind='stable')
    return {k: v[order] for k, v in windows.items()}, seconds


def phase_ngram_checks(url, ring):
    """The columnar NGram assembly (``form_ngram_columnar``) on one core
    over the store's decoded row groups, in windows/s; one epoch of windows
    through the thread pool and through the process pool (one worker per
    core each, the process pool on the shm transport), in windows/s, read,
    decode and assembly included; the process pool's windows equal the
    thread pool's, every field, and are every window of the store."""
    from petastorm_tpu_torch import make_reader

    with make_reader(url, output='columnar', reader_pool_type='dummy', shuffle_row_groups=False,
                     num_epochs=1) as reader:
        blocks = [dict(b._asdict()) for b in reader]
    ngram = seq_ngram(SEQ_WINDOW)
    t0 = time.perf_counter()
    assembled = sum(len(ngram.form_ngram_columnar(block)[0]['timestamp']) for block in blocks)
    one_core_s = time.perf_counter() - t0
    workers = max(1, os.cpu_count() or 1)
    thread, thread_s = _all_windows(url, reader_pool_type='thread', workers_count=workers)
    process, process_s = _all_windows(url, reader_pool_type='process', workers_count=workers,
                                      pool_kwargs={'ring_bytes': ring, 'transport': 'shm'})
    check_no_leftovers()
    expected = SEQ_ROWS - (SEQ_WINDOW - 1) * (SEQ_ROWS // SEQ_ROWS_PER_ROW_GROUP)
    equal = (sorted(thread) == sorted(process)
             and all(np.array_equal(thread[k], process[k]) for k in thread))
    n = len(thread['timestamp'])
    emit({'phase': 'ngram_checks', 'rows': SEQ_ROWS, 'window': SEQ_WINDOW, 'windows': n,
          'expected_windows': expected, 'workers': workers,
          'one_core_windows_per_s': assembled / one_core_s,
          'thread_pool_windows_per_s': n / thread_s, 'thread_pool_s': thread_s,
          'process_pool_windows_per_s': len(process['timestamp']) / process_s,
          'process_pool_s': process_s, 'process_equal_thread': equal})
    if not (equal and n == expected == assembled):
        raise AssertionError('ngram_checks: {} windows from the thread pool, {} assembled, {} '
                             'expected; process pool equal: {}'.format(n, assembled, expected,
                                                                       equal))


def phase_profile(torch, runs, images, labels):
    """For the raw path's eager and graphed step, each on its own state:
    three more train steps on one staged batch under ``torch.profiler``, the
    device's busy time per step by kernel and its idle share against that
    step's median step time on the path (taken without the profiler)."""
    for kind in ('eager', 'graphed'):
        state, train_step, _, result = runs[kind]
        _profile_step(torch, kind, state, train_step, images, labels,
                      result.extra['median_step_ms'])


def _profile_step(torch, kind, state, train_step, images, labels, step_ms, path='raw'):
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
    emit({'phase': 'profile', 'path': path, 'step': kind, 'steps': steps,
          'device_busy_ms_per_step': busy_ms,
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


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def main():
    os.makedirs(BUILD_DIR, exist_ok=True)
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(BUILD_DIR, 'triton'))
    # the flight files of this process and its pools' workers (the recorder
    # is on at the default counters level)
    flight_dir = os.path.join(BUILD_DIR, 'flight', 'main')
    shutil.rmtree(flight_dir, ignore_errors=True)
    os.environ['PSTPU_FLIGHT_DIR'] = flight_dir
    import torch

    import petastorm_tpu_torch  # noqa: F401 - fails here when run outside a checkout

    from petastorm_tpu_torch.native import build as native_build

    builds = {'reader': NativeBuild(native_build.build), 'image': NativeBuild(native_build.build_img),
              'ring': NativeBuild(native_build.build_ring)}
    card = phase_device(torch)
    kernels = phase_kernels(torch)
    work_dir = tempfile.mkdtemp(prefix='smoke_', dir=BUILD_DIR)
    try:
        probe = probe_host(builds)
        urls, stores = {}, {}
        for name in ('raw', 'png', 'png_fixed', 'jpeg', 'plain'):
            if name == 'jpeg' and probe['routes']['jpeg'] is None:
                continue
            path = os.path.join(work_dir, name)
            urls[name] = 'file://' + path
            t0 = time.perf_counter()
            if name == 'raw':
                build_store(urls[name])
            elif name == 'png_fixed':
                build_png_fixed_store(urls[name], probe['encoder'])
            elif name == 'plain':
                build_plain_store(urls[name])
            else:
                stores[name] = build_image_store(urls[name], name, JPEG_DIMS if name == 'jpeg'
                                                 else PNG_DIMS, probe['encoder'])
            emit({'phase': 'store', 'store': name, 'rows': ROWS, 'bytes': _dir_bytes(path),
                  'build_s': time.perf_counter() - t0})
        phase_decode_checks(urls['png'], stores['png'], urls.get('jpeg'), probe)
        phase_read_checks(urls['raw'], urls['png_fixed'])
        indexed_url = phase_filter_checks(urls['png_fixed'], urls['png'], stores['png'],
                                          work_dir)
        ring = phase_pool_checks(urls['raw'], urls['png_fixed'], probe, work_dir)
        check_no_leftovers()

        total, raw = run_path_both_ways(torch, 'raw', urls['raw'], check_batch)
        # the raw trainer as one host of an elastic pod, through a kill and
        # a join
        total.update(phase_raw_elastic(torch, urls['raw'], work_dir, raw))
        total.update(phase_raw_mesh(torch, urls['raw']))
        routes = probe['routes']
        cache_kwargs = {'cache_type': 'local-disk',
                        'cache_location': os.path.join(work_dir, 'disk_cache'),
                        'cache_size_limit': 10 << 30, 'cache_row_size_estimate': 200 << 10}
        image_kwargs = {'transform_spec': image_transform()}
        png_check = check_image_batch(expected_images(urls['png'], stores['png'], None))
        for name in ('png', 'png_cached', 'jpeg'):
            if name == 'jpeg' and routes['jpeg'] is None:
                emit({'phase': 'path', 'path': 'jpeg', 'skipped': True,
                      'why': 'the probe found no JPEG encoder (OpenCV) on this host',
                      'probe_modules': probe['modules'], 'native': probe['native']})
                continue
            kwargs = dict(image_kwargs)
            if name == 'png_cached':
                # one epoch fills the cache, so the runs below see every
                # later epoch: no decode, the transform still runs
                kwargs.update(cache_kwargs)
                from petastorm_tpu_torch import make_reader
                with make_reader(urls['png'], num_epochs=1, **kwargs) as reader:
                    for _ in reader:
                        pass
            fmt = 'jpeg' if name == 'jpeg' else 'png'
            check = png_check if fmt == 'png' else check_image_batch(
                expected_images(urls['jpeg'], None, routes['jpeg']['decode']))
            path_launches, runs = run_path_both_ways(torch, name, urls[fmt], check,
                                                     reader_kwargs=kwargs, routes=routes[fmt])
            if name == 'png':
                png_runs = runs
            if name == 'png_cached':
                for _, _, _, result in runs.values():
                    cache = result.extra['cache']
                    if cache['misses'] or not cache['hits']:
                        raise AssertionError('png_cached read {} row groups past the cache '
                                             '({} hits)'.format(cache['misses'], cache['hits']))
            total.update(path_launches)
        # the shared reader daemon: png through it, a second tenant beside
        # the trainer; its ring sized from /dev/shm's free bytes
        serve_ring, _ = ring_bytes_for(_dev_shm()['free_bytes'], 1, served_payload_bytes(),
                                       IMAGE_ROWS_PER_ROW_GROUP)
        total.update(phase_png_served(torch, urls['png'], png_check, png_runs, work_dir,
                                      serve_ring))
        phase_serve_checks(urls['raw'], urls['png_fixed'], serve_ring, work_dir)
        check_no_leftovers()
        # the pre-resized PNG store: every image decoded by the fused native read
        total.update(run_path_both_ways(torch, 'png_fixed', urls['png_fixed'], check_batch)[0])
        # the process pool: one spawned worker per core, shm rings
        process = {'reader_pool_type': 'process',
                   'pool_kwargs': {'ring_bytes': ring, 'transport': 'shm'}}
        for name, url, check, kwargs, named in (
                ('raw_process', urls['raw'], check_batch, dict(process, zero_copy=True), None),
                ('png_process', urls['png'], png_check, dict(process, **image_kwargs),
                 routes['png'])):
            total.update(run_path_both_ways(torch, name, url, check, reader_kwargs=kwargs,
                                            routes=named)[0])
            check_no_leftovers()
        # row filtering: a predicate on the fixed-shape PNG store, and a
        # row-group selector with shuffle-row-drop partitions on the PNG store
        from petastorm_tpu_torch.selectors import SingleIndexSelector
        selected_labels = {label_of(s) for s in selected_synsets()}
        for name, url, check, kwargs, named, label_check in (
                ('png_fixed_pred', urls['png_fixed'], check_batch,
                 {'predicate': filter_predicates()['in_set']}, None,
                 check_labels('below {}'.format(PRED_CLASSES), lambda v: v < PRED_CLASSES)),
                ('png_select', indexed_url, png_check,
                 dict(image_kwargs, shuffle_row_drop_partitions=ROW_DROP_PARTITIONS,
                      rowgroup_selector=SingleIndexSelector('noun_id_idx', selected_synsets())),
                 routes['png'], check_labels('of a selected synset',
                                             lambda v: np.isin(v, sorted(selected_labels))))):
            total.update(run_path_both_ways(torch, name, url, check, reader_kwargs=kwargs,
                                            routes=named, label_check=label_check)[0])
        # the plain store through make_batch_reader: rebatched to BATCH rows
        # on the reader side, the PNG bytes decoded by a batched transform
        readers = []
        total.update(run_path_both_ways(
            torch, 'plain_batch', urls['plain'], check_batch,
            reader_kwargs={'batch_size': BATCH, 'transform_spec': plain_transform()},
            reader_factory=plain_batch_factory(readers))[0])
        for reader in readers:
            check_plain_reader(reader)
        first_losses = {}
        for graphed in (False, True):
            launches, first_losses[graphed] = phase_plain_resume(torch, urls['plain'], graphed)
            total.update(launches)
        if abs(first_losses[False] - first_losses[True]) > FIRST_LOSS_TOL:
            raise AssertionError('plain_resume: first losses {}'.format(first_losses))
        phase_resume_checks(urls['plain'], check_thread_epoch_once(urls['plain']))
        total.update(phase_telemetry_checks(torch, urls['raw'], urls['png_fixed'],
                                            dict(process, zero_copy=True)))
        total.update(phase_autotune_checks(torch, urls['raw'], ring))
        phase_collate_checks(torch, work_dir)
        seq_url = 'file://' + os.path.join(work_dir, 'seq')
        t0 = time.perf_counter()
        seq_features = build_seq_store(seq_url)
        emit({'phase': 'store', 'store': 'seq', 'rows': SEQ_ROWS,
              'bytes': _dir_bytes(seq_url[len('file://'):]), 'build_s': time.perf_counter() - t0})
        phase_ngram_checks(seq_url, ring)
        phase_seq_paths(torch, seq_url, seq_features)
        phase_seq_checks(torch, seq_url)
        t0 = time.perf_counter()
        phase_seq_moe(torch, seq_url, seq_features)
        phase_moe_pp_checks(torch, seq_url)
        emit({'phase': 'moe_pp_phases', 'seconds': time.perf_counter() - t0})
        phase_flight_checks(urls['raw'], ring)
        from petastorm_tpu_torch.entry import dryrun_store
        mesh_url = 'file://' + os.path.join(work_dir, 'mesh')
        dryrun_store(mesh_url, 64)
        total['normalize'] += phase_mesh_checks(torch, mesh_url)
        total['normalize'] += phase_entry_checks(torch)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    # the raw path's first staged batch (eager run)
    images, labels = raw['eager'][2][0]
    phase_profile(torch, raw, images, labels)
    phase_model_check(torch, raw['eager'][0].model, images)
    for entry in kernels:
        entry['launches'] = total[entry['name']]
    emit({'kernels': kernels})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})


if __name__ == '__main__':
    sys.exit(main())
