"""chip_smoke.py: the quickest proof that petastorm_tpu_torch runs on an NVIDIA GPU.

Run from the root of a checkout, on a host with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card, its power limit, and the TF32 settings used;
2. kernel checks: every hand-written kernel of the main path against its plain
   PyTorch version on the card (shapes, types and tolerances below), and the
   times of both and of the one PyTorch call that computes the same function
   (CUDA events, median of 25 runs), at the main path's shape and at
   ``raw_crop``'s (64x144x144x3: ``crop_timing``); then the batch-norm
   kernels (``bn_kernel_checks``) at three of ResNet-50's shapes at batch
   256 in bf16, held against their plain version and timed alone, as a
   whole forward, beside their plain version, ATen's ``native_batch_norm``
   and the ATen path the model ran before them;
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
   - ``raw_crop``: ``raw`` with a step that draws more than the flip mask:
     ``RandomCropFlip(144, 144, then=normalize_images)`` crops each 160 px
     image at offsets drawn per image from the step's generator, flips it
     and normalizes it (the Triton kernel) inside the step, the graphed step
     with the offsets and mask copied into buffers of their own before each
     replay; the model sees 64x144x144x3 only; the graph check runs the same
     batches with the same draws; a ``raw_crop_vs`` line beside ``raw``'s
     numbers;
   - then ``throughput_checks`` (no train step): ``python -m
     petastorm_tpu_torch.tools.throughput`` on the raw store, ``-d python``
     in a fresh process, ``-d columnar``, ``-d torch`` (staged on the card)
     and ``-d torch -p process``, each measured for seconds after a
     warm-up, and a short ``-d python --trace-out`` run whose trace must
     parse; an in-process ``reader_throughput(read_method='torch')`` whose
     batches must be on the card; each run's samples/s, MB RSS, CPU%, stall,
     bottleneck and window, ``torch`` over ``columnar`` and over ``raw``'s
     graphed examples/s;
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
   - ``raw_mix``: ``raw``'s trainer fed by ``MixtureReader([A, B],
     weights=[7, 3], seed=7)`` (``docs/sequence.md:97-150``) over
     ``make_reader(output='columnar', num_epochs=None)`` of the raw store
     (A) and of a second raw store of 256 rows with the same schema (image
     indices 1024-1279, a ``store`` line), each with half the workers; every
     staged row a row of A or B, each source's rows 64 x its count in a host
     replay of the seeded draws (``default_rng(7)``, ``searchsorted`` over
     ``[0.7, 1.0]``), exactly, and a two-source ``mixture`` section in the
     stall report; a ``mixture`` line per run and a ``raw_mix_vs`` line
     beside ``raw``'s numbers;
   - ``raw_tail``: ``raw``'s trainer reading ``TailFollowingReader(url,
     poll_interval=0.05, idle_timeout=120, output='columnar')`` over a fresh
     store that a host process (no torch) fills with the raw store's 1024
     rows through ``DatasetWriter``, publishing every 128 rows (8
     snapshots, the last final) while the trainer reads; a fresh store and
     writer for each step kind. No row staged twice, every staged row one
     the writer wrote, ``dataset_grew`` equal to the snapshots adopted, at
     least 832 rows delivered, the writer exited 0 and reaped; a ``tail``
     line per run (snapshots adopted, the writer's rows/s, the tail's
     polling seconds);
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
   a ``/dev/shm/pstpu_*`` entry of this process left behind. Then
   ``raw_chaos``: ``raw_process``'s reader (8 workers, one epoch, the
   protocol monitor armed, ``on_error='retry'``) under a ``FaultPlan`` that
   SIGKILLs, SIGSEGVs and fails once the workers of three row groups among
   the first ten the seed ventilates (:func:`phase_raw_chaos`): every fault
   fires inside the 13 steps, the rest of the epoch is read on the host
   after them, each of the 1024 rows is delivered once, 2 restarts, at least
   3 requeues, nothing quarantined, the monitor's drain counts 16 with none
   in flight, and the segfaulted worker's flight file and ``diagnose
   --postmortem`` name ``SIGSEGV`` in ``worker.item`` (``chaos`` and
   ``raw_chaos_vs`` lines); then two host phases: ``monitor_checks`` (the
   model checker's CLI on four scopes, their state counts the JAX
   checker's, beside a serve daemon whose two tenants go through a detach
   and an eviction and an elastic pod through a SIGKILL and a join, all
   with their monitors armed) and ``diagnose_checks`` (a one-shot
   ``diagnose`` of the raw store, ``--pod`` over two reader processes'
   exports naming the slowed one, and the autotune replay of a ``--watch
   --json`` history). Two more read
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
     that of a selected synset;
   - ``png_part``: the ``png`` store's rows, cells as written,
     Hive-partitioned by ``noun_id`` through ``materialize_dataset(
     partition_by=['noun_id'])`` (32 ``noun_id=<synset>/`` directories, 64
     row groups; a ``store`` line), read with the ``png`` path's transform
     and ``predicate=in_set(<png_select's 16 synsets>, 'noun_id')``: the
     partition pruning keeps 32 row groups (512 rows an epoch) before any
     worker opens a file and leaves the workers no predicate, ``noun_id``
     comes from the path (only ``text`` and ``image`` are read, through
     Arrow), every delivered label is a selected synset's and the first
     staged batch matches those synsets' images; a ``png_part_vs`` line sets
     its examples/s, median step ms and stall beside ``png``'s and
     ``png_select``'s of the call.

   Then ``etl_checks``, on the host, each sub-check's seconds: the
   fixed-shape PNG store's cells with an int64 ``day`` partition column
   (``row // 256``, a file a row group: 64 files), grown by a fifth day of
   256 rows under ``materialize_dataset(append=True)``: its
   ``_common_metadata`` lists exactly the five days' 80 files, and one epoch
   through the process pool (4 workers, ``zero_copy=True``) decodes every
   row group in place, ``day`` framed as a raw column, to the rows of the
   thread pool and the rows written (1280); a copy of the fixed-shape PNG
   store whose ``_common_metadata`` carries only the original petastorm
   library's keys (its pickled unischema with ``CompressedImageCodec('png')``
   and ``ScalarCodec(LongType)``, JSON counts, a pickled
   ``SingleFieldIndexer`` on ``label``; the pickles made by
   :mod:`petastorm_tpu_torch.test_util.legacy_fakes`) reads through the
   fused route to the store's rows, a ``SingleIndexSelector`` over its
   legacy index picks the row groups of a native index and reads them, and
   ``copy_dataset`` migrates it to a native store that reads equal; the
   64-file copy of the day store lists the same pieces by its stored
   counts, by a ``_metadata`` summary file with no counts stored and by its
   footers (each route's seconds), and ``generate_metadata`` writes its
   counts back under the stored schema and, once ``_common_metadata`` is
   deleted, restores it with an inferred schema. Then ``tail_checks``, on
   the host, on the label column of a raw store a writer process grows (8
   snapshots): the tail drains to the final snapshot with every row once;
   a ``state_dict()`` inside the second delta and a resume deliver the rest
   once; a torn ``snap-000008.json`` is skipped; a store whose only
   snapshot is not final raises at ``idle_timeout`` after its rows.

   One more reads the plain store through ``make_batch_reader``:

   - ``plain_batch``: ``make_batch_reader(batch_size=64)`` (the reader
     rebatches its 16-row row groups) with a batched ``TransformSpec`` that
     decodes the ``image`` column's PNG bytes with the port's native decoder
     (``edit_fields``: uint8 160x160x3): every block the loader received has
     64 rows, the schema was inferred (``image``, ``label``), the ``label``
     column came from the fused read and the ``binary`` image column through
     Arrow (reason ``codec``), and the first staged batch is rows of the
     store;
8a. remote stores (``mock-remote://``: the store's local files behind the
   retry wrapper the object stores get, so a cold epoch measures mirroring,
   not a network), right after ``png_fixed`` so that both local paths of
   the call stand beside them:

   - ``raw_remote``: one cold epoch of the raw store through the thread pool
     into an empty ``chunk_cache`` with ``storage_retry_policy`` and
     ``faults.FaultPlan(storage_fail_first=8)`` installed: exactly the
     store's rows, every fault retried, and every chunk that qualifies (each
     footer's tail and every ``pagescan.column_qualifies`` chunk) fetched
     once, by a demand miss or ahead by the prefetcher, into one mirror
     (``remote_cold`` line: rows/s, retries, bytes fetched and on disk);
     then ``raw``'s two runs from the warm cache: no miss, byte fetched or
     prefetch during either, the page scan over the mirrors (``pagescan``
     stages, hits covering every column ``raw`` served by the page scan in
     this call, no ``arrow_decode`` or ``chunk_fetch`` stage), graphed
     losses as eager; a ``remote_vs_local`` line beside ``raw``'s numbers;
   - ``png_fixed_remote``: the fixed-shape PNG store the same way, every
     chunk mirrored and decoded by the fused call from the mirrors (one
     ``fused_decode`` stage per row group read, two columns each);
   - ``remote_checks``: the process pool (``zero_copy=True``) over the raw
     store into an empty cache, its blocks equal to the thread pool's,
     every row group decoded in place from the mirrors, and the counters
     merged from the workers' stats files adding up to the epoch's chunks;
     a cache bounded at three image chunks under batches held while
     ``prefetch_to_device`` stages them (chunks skipped as pinned, every
     held and staged row equal to the store's after more eviction pressure);
     the prefetcher ahead of demand and within its in-flight budget; an
     exhausted retry policy raising the original error, a permanent error
     not retried; the fixed-shape PNG store through the serve daemon with
     ``chunk_cache``, the tenant's blocks equal to a private reader's and
     the stream's cache in the daemon's stats; each check's seconds;
   - ``raw_fabric``: ``raw``'s trainer as host ``h0`` of a pod whose other
     host ``h1`` is a peer process (``petastorm_tpu_torch.fabric.
     _peerproc``, no torch) that warmed its own mirror of the mock-remote
     raw store and serves it; for each step kind the trainer starts and
     installs a fabric node of its own (``FabricConfig(coord, 'h0-<kind>',
     ...)``) over an empty chunk cache: every chunk the run populates
     (demand misses and prefetched chunks) a verified copy from ``h1``'s
     mirror, no fallback, no ``retry.fetch_range`` call (no chunk read from
     the object store) and no Arrow decode in the trainer's process; a
     ``fabric_vs_remote`` line beside ``raw_remote``'s cold epoch and warm
     runs of this call (examples/s, median step ms, stall, peer copies per
     second and bytes, the pod's object-store chunk reads per distinct
     chunk: 1.0 with the fabric, 2.0 for two hosts without it);
   - ``fabric_checks``: the drill of ``docs/fabric.md`` on the raw store
     (peer A, a peer process, stalls every payload and is SIGKILLed once a
     request reached it; peer B, a node of this process, resets one payload
     and truncates one; host C reads an epoch through the thread pool with
     a ``FabricMonitor``: the rows the store's, C's mirrors byte-equal to
     B's, peer hits plus fallbacks equal to C's populations and both above
     0, A no hit and at least one failure); the same epoch through the
     process pool with a node installed, whose spawned workers' stats files
     show the peer copies; ``modelcheck --fabric`` at its default scope
     (435631 states, clean) and with ``--mutate no_fallback`` (exit 1);
     ``diagnose --fabric`` on the drill's pod directory, its table printed;
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
   bit-exact, and each consumer's real tokens/s; then ``mixture_checks``
   (host) on the same store split into two sources (shards 0 and 1 of 2,
   ``token_field='tokens'``): ``renormalize`` delivers every row once,
   ``stop`` ends at the first dry source, a live ``set_weights`` takes
   effect, ``MixtureSchedule({0: [7, 3], 1: [5, 5]})`` at ``reset()``
   (each epoch's rows per source a host replay of the draws), the token
   counts are the rows' lengths, one seed gives one interleaving;
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
15a. ``seq_example``: ``petastorm_tpu_torch.examples.sequence.
   torch_sequence_example.train`` on the same store, the example's own
   flow: the window stacked on the host and only ``features`` and the
   labels staged (2 tensors a batch, synchronously), against ``seq_ring``'s
   graphed flow (24 on the prefetch thread; its ``path`` lines tagged
   ``beside_seq_example``), 3 + 100 graphed steps each, in turns (ring,
   example, example, ring): examples/s, the stall (the loop's wait for its
   batch over the wall time of the measured steps), the median device ms
   between consecutive steps' ends, and the ratio of the median
   examples/s;
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
19a. the last device ops, ``MnistCNN`` and the example twins
   (``petastorm_tpu_torch.examples``; their prints captured, counted on
   their lines; an ``example_phases`` line gives each phase's seconds):
   a ``store`` line for the MNIST store (``BASELINE.json`` config 1 at
   MNIST's published split: 60000 train and 10000 test rows of the
   generator's synthetic digits, 200 rows per row group); ``mnist``, one
   line per step kind: ``torch_example.train_and_test`` (batch 32, lr 0.05,
   seed 0, one epoch; test accuracy above 0.5, finite losses) with the
   final loss, the test accuracy and the example's seconds, beside the
   examples/s, median step ms and stall of ``pipeline_duty_cycle`` over the
   example's reader and loader arguments (3 + 200 steps), then a
   ``graph_check`` (1e-5); ``mnist_resume``: ``resume_example.
   train_with_checkpointing`` on the dummy pool to step 100 with a
   checkpoint every 50, the last deleted and the call repeated: steps 51-100
   train on the uninterrupted run's rows (images and digits equal) and
   losses (1e-5); ``imagenet_example``: ``torch_resnet_example.train`` on
   the PNG store for 3 + 10 graphed steps (its normalize launches count in
   the ``kernels`` line); ``hello_checks``: both hello-world stores, each
   ``torch_hello_world``'s batches on the card equal to its CPU read;
   ``augment_checks``: ``random_crop`` (128), ``mixup`` (alpha 0.2) and
   ``cutmix`` (alpha 1.0) on a 64x160x160x3 uint8 batch with 1000 classes,
   each apply on the card equal to the CPU's from the same draws (mixup
   within 1, soft labels within 1e-6), its time beside its HBM-bytes bound;
   ``converter_checks``: the MNIST test split as a ``pyarrow.Table``
   (``digit`` int64, ``image`` list<float32> of 784) through
   ``make_converter`` (4 MiB row groups; a second call the same cache URL),
   ``make_torch_loader(batch_size=32, num_epochs=1, device='cuda')``
   driving ``MnistCNN`` eager steps over the epoch on the card (finite
   losses), ``make_torch_dataloader`` over two shards (every row once), and
   ``delete()``; on a host without pandas a declared ``skipped`` line;
19b. ``sanitize_checks``: the port's reader, image decoder and ring built
   with ``PSTPU_SANITIZE=address,undefined`` (three g++ at once, into
   ``.san.so`` files) and ``petastorm_tpu_torch/test_util/native_corpus.py``
   replayed through them in a subprocess with ``libasan``/``libubsan``
   preloaded (the fuzz corpus, the corrupt-chunk regressions with the map of
   bools, the compressed frames, the page statistics, PNG cells and resizes,
   the ring and lifetime cycles): the build and replay seconds and the items
   replayed; a finding fails the run; a host whose g++ ships no sanitizer
   runtime prints one ``skipped`` line;
19c. ``race_checks`` (host only: no device work): the port's interleaving
   explorer through ``python -m petastorm_tpu_torch.analysis.schedule.cli``
   over its five component scenarios (the port's ventilators, shuffling
   buffer, slot registry and autotuner) at the CLI's defaults (300 random
   schedules, ``--dfs-budget 100``, ``--max-preemptions 2``) in one
   process, each clean, with its seconds (the first's with the
   interpreter's start); the torn counter, the pre-fix ventilator flags and
   the ABBA deadlock caught in another, and each failure replayed through
   ``PSTPU_SCHEDULE`` in a process of its own with the same report (a
   deadlock's object addresses aside);
19d. ``lint_checks`` (host work, apart from the capture probes): the port's
   static linter, ``python -m petastorm_tpu_torch.analysis`` over the
   installed port package with ``--format json`` and ``--format sarif``
   (exit 0, the open and suppressed findings by code, the SARIF document
   parsed), and the race CLI's ``lint`` mode (the PT13xx pass, exit 0), the
   three at once; then PT400 (CUDA-graph capture purity) held against real
   captures: every function of ``tests/torch_lint_fixtures/PT400/bad`` is
   flagged by the linter and, captured on the card in a process of its own,
   shows its symptom (a sync fails the capture; a host clock or RNG value
   repeats in two replays where two eager calls differ; a reseed fails the
   capture or does not replay), and every function of ``clean/`` is not
   flagged and replays equal to its eager call within ``REPLAY_LOSS_TOL``;
20. profile: three more steps of the raw path under ``torch.profiler``, with
   the eager and with the graphed step, each on its own state: the device's
   busy time per step by kernel and its idle share;
21. model check: the trained model on the card (bf16) against a float32 copy
   of it on the CPU, on four images of the store;
22. a ``kernels`` line (per kernel: route, source, the TPU kernel it replaces,
   launches over all paths (``raw_crop``, ``png_part``, ``raw_mix``,
   ``raw_tail``, ``raw_chaos`` and ``raw_fabric`` included), both steps, where a
   graph replay counts the launches it captured, and the spawned ranks' of
   ``mesh_checks`` and ``entry_checks``, and ``imagenet_example``'s and the
   remote paths'; the sequence, MoE, pipeline and MNIST paths normalize
   nothing), max error, its time, the plain version's time, the least time
   the card could take and what bounds it, and the time of the one PyTorch
   call that computes the same function, ``torch.addcmul``), the card's
   name and power limit as ``nvidia-smi`` gives them, and last
   ``{"ok": true, "device": {...}}``.

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
import hashlib
import json
import math
import os
import re
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
#: raw_crop's step crops each 160 px image to this size before the model
CROP_SIZE = 144
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


def _normalize_timings(torch, shape, gen):
    """The Triton normalize, its plain version and ``torch.addcmul`` timed
    in turns at ``shape`` (uint8 in, bf16 out) on 16 inputs, the library
    call checked within 1 bf16 ulp of the plain version, and the bound."""
    from petastorm_tpu_torch.ops.kernels import normalize as nk

    dev = torch.device('cuda')
    inputs = [torch.from_numpy(gen.integers(0, 256, shape, dtype=np.uint8)).to(dev)
              for _ in range(16)]  # 64-79 MB of input: more than L2 holds
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
    del inputs
    return {'timing_shape': list(shape), 'ms_runs': kernel_ms, 'plain_ms_runs': plain_ms,
            'library': library_check, 'launch_rate_ms': host_rate_ms,
            'ms': statistics.median(kernel_ms), 'plain_ms': statistics.median(plain_ms),
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': statistics.median(library_ms) if library_ok else None,
            # the bytes the bound counts, over the kernel's time
            'hbm_gb_per_s': bound_ms / statistics.median(kernel_ms) * HBM_BYTES_PER_S / 1e9}


def phase_kernels(torch):
    """The Triton normalize against its plain version, then both timed at
    the main path's shape and at ``raw_crop``'s (the batch cropped to
    ``CROP_SIZE`` inside the step). Returns the kernels-line entry (the main
    path's shape) without launches."""
    from petastorm_tpu_torch.ops.kernels import normalize as nk

    dev = torch.device('cuda')
    gen = np.random.default_rng(0)
    checks = []
    cases = [((BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), torch.uint8, torch.bfloat16),
             ((BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), torch.uint8, torch.float32),
             ((BATCH, CROP_SIZE, CROP_SIZE, 3), torch.uint8, torch.bfloat16),
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

    main = _normalize_timings(torch, (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3), gen)
    crop = _normalize_timings(torch, (BATCH, CROP_SIZE, CROP_SIZE, 3), gen)
    line = {'phase': 'kernel_checks', 'kernel': 'normalize', 'checks': checks}
    line.update((k, main[k]) for k in ('timing_shape', 'ms_runs', 'plain_ms_runs', 'library',
                                       'launch_rate_ms', 'hbm_gb_per_s'))
    # raw_crop's shape: each number as at the main path's shape
    line['crop_timing'] = crop
    emit(line)
    return [{'name': 'normalize', 'route': 'triton',
             'source': 'petastorm_tpu_torch/ops/kernels/normalize.py',
             'replaces': 'petastorm_tpu/ops/preprocess.py:43',
             'launches': None, 'max_abs_err': main_err,
             'ms': main['ms'], 'plain_ms': main['plain_ms'],
             'bound_ms': main['bound_ms'], 'bound_by': main['bound_by'],
             'library_ms': main['library_ms']}]


#: ResNet-50's batch norms at batch 256 and 224 px timed by ``phase_bn_kernels``:
#: (N, C, H, W, epilogue): bn_init, a stage-1 block's bn3, a stage-4 block's bn3
BN_TIMING_SHAPES = [((256, 64, 112, 112), 'relu'), ((256, 256, 56, 56), 'residual_relu'),
                    ((256, 2048, 7, 7), 'residual_relu')]


def _bn_inputs(torch, shape, count, gen, dtype):
    """``count`` channels-last ``(N, C, H, W)`` activations of ``dtype`` with
    a per-channel offset and spread, made on the card from ``gen``."""
    dev = torch.device('cuda')
    c = shape[1]
    g = torch.Generator(device=dev)
    g.manual_seed(int(gen.integers(1 << 31)))
    shift = torch.from_numpy(gen.normal(0.0, 2.0, c).astype(np.float32)).to(dev)
    spread = torch.from_numpy(gen.uniform(0.5, 2.0, c).astype(np.float32)).to(dev)
    out = []
    for _ in range(count):
        x = torch.randn(shape, generator=g, device=dev)
        x = x * spread[None, :, None, None] + shift[None, :, None, None]
        out.append(x.to(dtype).contiguous(memory_format=torch.channels_last))
    return out


def phase_bn_kernels(torch):
    """The batch-norm kernels (``ops/kernels/batchnorm.py``) at ResNet-50's
    shapes in bf16: held against their plain version, then each kernel
    timed alone, the whole forward, the plain version, ATen's
    ``native_batch_norm`` (the library call, never called by the port) and
    the ATen path the model ran before (``native_batch_norm``, the residual
    add, ``relu``), each beside its bytes bound. Emits one line."""
    import torch.nn.functional as F

    from petastorm_tpu_torch.ops.kernels import batchnorm as bn

    dev = torch.device('cuda')
    gen = np.random.default_rng(11)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out = []
    for shape, epilogue in BN_TIMING_SHAPES:
        n, c, h, w = shape
        m = n * h * w
        size = 2  # bf16
        relu, has_res = True, epilogue == 'residual_relu'
        # enough inputs that they do not stay in the 50 MB L2 cache
        count = max(2, min(16, -(-600_000_000 // (m * c * size))))
        xs = _bn_inputs(torch, shape, count, gen, torch.bfloat16)
        res = _bn_inputs(torch, shape, 1, gen, torch.bfloat16)[0] if has_res else None
        scale = torch.from_numpy(gen.uniform(0.5, 1.5, c).astype(np.float32)).to(dev)
        bias = torch.from_numpy(gen.normal(0, 0.1, c).astype(np.float32)).to(dev)
        running = [torch.zeros(c, device=dev), torch.ones(c, device=dev)]

        # -- checked against the plain version --------------------------------
        ref_running = [t.clone() for t in running]
        y, save_mean, save_invstd = bn.batch_norm_train(
            xs[0], scale, bias, *running, relu=relu, residual=res)
        torch.cuda.synchronize()
        ref_y, ref_mean, ref_var = bn.batch_norm_train_reference(
            xs[0], scale, bias, *ref_running, relu=relu, residual=res)
        ref_invstd = torch.rsqrt(ref_var + 1e-5)
        # the mean's error relative to the channel's scale, |mean| + std
        mean_err = float(((save_mean - ref_mean).abs()
                          / (ref_mean.abs() + ref_var.sqrt())).max())
        invstd_err = float(((save_invstd - ref_invstd).abs() / ref_invstd).max())
        y_diff = (y.float() - ref_y.float()).abs()
        y_ok = bool((y_diff <= 2.0 ** -7 * ref_y.float().abs() + 1e-4).all())
        run_err = max(float((a - b).abs().max()) for a, b in zip(running, ref_running))
        check = {'mean_rel_err': mean_err, 'invstd_rel_err': invstd_err,
                 'y_max_abs_err': float(y_diff.max()), 'y_within_1_ulp': y_ok,
                 'running_max_abs_err': run_err}
        del y, ref_y, y_diff
        if not (mean_err <= 1e-5 and invstd_err <= 1e-5 and y_ok and run_err <= 1e-5):
            raise AssertionError('batch norm kernels disagree with their plain version at '
                                 '{}: {}'.format(shape, check))

        # -- timed, through the wrapper's launches ------------------------------
        _, slabs, rows = bn.stats_grid(m, c, sms)
        partials = torch.empty((2, slabs, c), dtype=torch.float32, device=dev)
        per_channel = torch.empty((4, c), dtype=torch.float32, device=dev)
        out = torch.empty_like(xs[0])

        def stats(x):
            bn._launch_stats(x, partials, rows)

        def finalize(x):
            bn._launch_finalize(partials, m, rows, scale, bias, *running, per_channel, 0.9, 1e-5)

        def apply(x):
            bn._launch_apply(x, per_channel[2:], res, out, relu)

        def forward(x):
            return bn.batch_norm_train(x, scale, bias, *running, relu=relu, residual=res)

        def plain(x):
            return bn.batch_norm_train_reference(x, scale, bias, *running, relu=relu,
                                                 residual=res)

        def library(x):
            return torch.native_batch_norm(x, scale, bias, None, None, True, 0.0, 1e-5)

        def aten_path(x):
            y = torch.native_batch_norm(x, scale, bias, None, None, True, 0.0, 1e-5)[0]
            return F.relu(res + y if has_res else y)

        times = {}
        # in turns: each timed twice, the second pass in reverse order
        order = [('stats', stats), ('finalize', finalize), ('apply', apply),
                 ('forward', forward), ('library', library), ('aten_path', aten_path),
                 ('plain', plain)]
        for name, fn in order + order[::-1]:
            times.setdefault(name, []).append(cuda_ms(torch, fn, xs))
        x_bytes = m * c * size
        bounds = {'stats': x_bytes, 'apply': x_bytes * (3 if has_res else 2),
                  'finalize': 2 * slabs * c * 4 + 12 * c * 4,
                  'forward': x_bytes * (4 if has_res else 3),
                  'aten_path': x_bytes * (4 if has_res else 3),
                  'library': x_bytes * 3}
        row = {'shape_nchw': list(shape), 'epilogue': epilogue, 'm': m, 'c': c,
               'slabs': slabs, 'rows_per_slab': rows, 'check': check,
               'ms_runs': times}
        for name, runs in times.items():
            row[name + '_ms'] = statistics.median(runs)
        for name, nbytes in bounds.items():
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            row[name + '_bound_ms'] = bound_ms
            row[name + '_share_of_bound'] = bound_ms / row[name + '_ms']
        rows_out.append(row)
        del xs, res, partials, out
        torch.cuda.empty_cache()
    emit({'phase': 'bn_kernel_checks', 'sms': sms, 'blocks': {
        'stats': [bn._STATS_BLOCK_M, bn._STATS_BLOCK_C, bn._STATS_WARPS,
                  bn._STATS_PROGRAMS_PER_SM],
        'finalize': [bn._FINALIZE_BLOCK_P, bn._FINALIZE_BLOCK_C],
        'apply': [bn._APPLY_BLOCK_M, bn._APPLY_BLOCK_C, bn._APPLY_WARPS]}, 'rows': rows_out})


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


def raw_schema():
    from petastorm_tpu_torch.codecs import RawTensorCodec, ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    return Unischema('RawImagenet', [
        UnischemaField('image', np.uint8, (IMAGE_SIZE, IMAGE_SIZE, 3), RawTensorCodec(), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False)])


def raw_row(i):
    """Row ``i`` of the raw stores: image ``i`` and label ``i % 1000``."""
    return {'image': _image(i), 'label': np.int64(i % NUM_CLASSES)}


def build_store(url, first=0, rows=None):
    """The raw store: ``rows`` (``ROWS``) rows from ``first`` on
    (:func:`raw_row`), 64 a row group, uncompressed."""
    from petastorm_tpu_torch.etl import materialize_dataset

    rows = ROWS if rows is None else rows
    with materialize_dataset(url, raw_schema(), rows_per_row_group=ROWS_PER_ROW_GROUP,
                             compression='none') as writer:
        for i in range(first, first + rows):
            writer.write(raw_row(i))


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
    for module in ('pandas', 'tensorflow', 'pyspark'):
        # looked up, not imported: TensorFlow's import takes seconds and
        # would claim the card beside the trainer
        found[module] = _installed_version(module)
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


def _installed_version(module):
    """The installed distribution's version of ``module``, or None when it
    cannot be imported (``'unknown'`` when its distribution has another
    name)."""
    import importlib.metadata
    import importlib.util

    if importlib.util.find_spec(module) is None:
        return None
    try:
        return importlib.metadata.version(module)
    except importlib.metadata.PackageNotFoundError:
        return 'unknown'


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
                                             'filesystem_factory': pafs.LocalFileSystem})
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
    from petastorm_tpu_torch.workers import ProcessPoolOptions

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
    process = ProcessPoolOptions(**pool_kwargs)
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

            run = _read_blocks(url, epochs, warm, compare, reader_pool_type=process,
                               zero_copy=mode == 'zero_copy')
            _check_pool_run('{} {}'.format(store, mode), run, blocks, mismatched)
            runs['{}_process_{}'.format(store, mode)] = run

    # a worker SIGKILLed mid-item: the pool respawns it and requeues the item
    schema = get_schema(raw_url)
    pieces = load_row_groups(raw_url)
    pool = ProcessPool(workers, serializer=NumpyBlockSerializer(), results_timeout_s=120,
                       **pool_kwargs)
    pool.start(KillOnceWorker, {
        'filesystem_factory': pafs.LocalFileSystem, 'dataset_path': raw_url[len('file://'):],
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
    process's rings or blob dirs is left. The chunk stores of this process
    keep their hottest mirror mappings alive by design (a strong pool of
    64 each): they are closed first, so that a mapping still counted is one
    a batch holds."""
    import gc

    from petastorm_tpu_torch.chunkstore import store as chunk_store
    from petastorm_tpu_torch.native.lifetime import registry

    with chunk_store._stores_lock:
        stores = list(chunk_store._stores.values())
    for store in stores:
        store.close()
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
    ``raw_elastic``, ``raw_mix`` and ``raw_tail`` as ``raw`` (a mixture's
    sources and a tail's delta readers are raw stores read by the row
    worker); ``raw_remote`` and ``raw_fabric`` no route counted (the chunk
    reader counts none: :func:`phase_remote_path` and
    :func:`phase_raw_fabric` check their stages);
    ``png_fixed`` and ``png_fixed_remote`` fused only; ``png_process``
    as ``png``; ``raw_process`` fused only, every fused batch decoded in
    place into a ring slot, two columns each; ``png_fixed_pred`` every row
    group through the fused predicate call, two columns each, with pages
    skipped by their statistics; ``png_part`` ``text`` and ``image``
    through Arrow (``noun_id`` is the partition column, filled in from the
    path); ``png_select`` all three columns through
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
    if path in ('raw', 'raw_crop', 'raw_mesh', 'raw_elastic', 'raw_mix', 'raw_tail'):
        ok = pagescan > 0 and not (fused or fallback or arrow or reasons)
    elif path in ('png', 'jpeg', 'png_process'):
        n = reasons.get('image-hints', 0)
        ok = (n > 0 and reasons == {'image-hints': n, 'codec': 2 * n} and fallback == 3 * n
              and arrow == 3 * n and not (fused or pagescan))
    elif path == 'png_part':
        # noun_id comes from the path: only text and image are read
        n = reasons.get('image-hints', 0)
        ok = (n > 0 and reasons == {'image-hints': n, 'codec': n} and fallback == 2 * n
              and arrow == 2 * n and not (fused or pagescan))
    elif path in ('png_cached', 'png_served', 'raw_remote', 'raw_fabric'):
        # raw_remote, raw_fabric: the chunk reader serves the page scan over its mirrors
        # and counts no read route; its stage timers and chunk_cache_*
        # counters show the route (phase_remote_path)
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
    elif path in ('raw_process', 'raw_chaos'):
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


#: batch norms of ResNet-50 (the stem's, three in each of 16 blocks and 4
#: projections): a training step launches the batch-norm kernels for each
RESNET50_BATCH_NORMS = 53


def reset_launches():
    """Zero the normalize and batch-norm kernels' launch counters."""
    from petastorm_tpu_torch.ops.kernels import batchnorm, normalize

    normalize.launches = batchnorm.launches = 0


def kernel_launches():
    """The normalize and batch-norm kernels' launches since
    :func:`reset_launches` (a graph replay adds the launches it captured)."""
    from petastorm_tpu_torch.ops.kernels import batchnorm, normalize

    return {'normalize': normalize.launches, 'batchnorm': batchnorm.launches}


def check_launches(name, launches, steps):
    """Every one of ``steps`` ResNet-50 training steps launched the
    normalize kernel once and, on the card (elsewhere batch norm runs
    ATen's code), the batch-norm kernels for each batch norm."""
    from petastorm_tpu_torch.ops.kernels import batchnorm

    per_step = {'normalize': 1,
                'batchnorm': RESNET50_BATCH_NORMS * batchnorm.KERNELS_PER_CALL
                if DEVICE_TYPE == 'cuda' else 0}
    for kernel, count in launches.items():
        if count < per_step[kernel] * steps:
            raise AssertionError('{}: kernel {} launched {} times in {} steps'.format(
                name, kernel, count, steps))


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
    'raw_crop': ({'worker.read_io'}, {'worker.fused_decode'}),
    # the wait at the pod's epoch barrier has no stage of its own: the pool
    # wait is shared out over the timed worker stages, here the read
    'raw_elastic': ({'worker.read_io'}, {'worker.fused_decode'}),
    # both sources' readers time into the one registry
    'raw_mix': ({'worker.read_io'}, {'worker.fused_decode'}),
    # the tail's wait for a snapshot is no pool wait, and between two deltas
    # its diagnostics hold no reader's, so no stage is sure to be named
    'raw_tail': (set(), {'worker.fused_decode'}),
    'png': ({'worker.decode', 'worker.read_io'}, {'worker.fused_decode'}),
    'jpeg': ({'worker.decode'}, {'worker.fused_decode'}),
    'png_process': ({'worker.decode'}, {'worker.fused_decode'}),
    'png_select': ({'worker.decode'}, {'worker.fused_decode'}),
    'png_part': ({'worker.decode', 'worker.read_io'}, {'worker.fused_decode'}),
    'png_fixed': ({'worker.fused_decode'}, {'worker.decode', 'worker.read_io'}),
    # a warm chunk cache: the page scan over the mirrors inside the read
    # stage, the fused call from the mirrors; no chunk is fetched
    'raw_remote': ({'worker.read_io'}, {'worker.fused_decode', 'worker.chunk_fetch'}),
    # a cold chunk cache filled by a pod peer: the page scan over the
    # mirrors, the fetches inside the read; no stage is sure to be named
    'raw_fabric': (set(), {'worker.fused_decode'}),
    'png_fixed_remote': ({'worker.fused_decode'},
                         {'worker.decode', 'worker.read_io', 'worker.chunk_fetch'}),
    'raw_process': ({'worker.fused_decode'}, {'worker.decode', 'worker.read_io'}),
    'raw_chaos': ({'worker.fused_decode'}, {'worker.decode', 'worker.read_io'}),
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
             on_step=None, mesh=None, rows_check=None, preprocess_fn=None):
    """One path: a fresh model from the seed, 3 warm-up and ``steps``
    measured steps through ``pipeline_duty_cycle``, with the eager step or
    (``graphed``) the graphed one, at the ``telemetry`` level. The kernel
    launches (:func:`kernel_launches`), the image route
    counts, the read route counts and the telemetry registry and span ring
    cover this run alone. ``label_check`` is handed every label the steps
    saw, after the run (the labels stay on the card until then: no
    synchronisation in the steps), and ``rows_check`` the keys
    (:func:`_row_keys`) of every row the steps saw, in order, after the run
    (the batches stay on the card until then); ``on_step`` is called after
    each step.
    The line carries the stall report of the loader's diagnostics
    (``stall``), checked against the path's routes. Returns the launches,
    the state, the step, the first :data:`SAME_BATCHES` staged batches, the
    result and the losses. With a ``mesh``, the example's mesh flow: the
    state sharded onto it, the reader on this rank's shard
    (``reader_shard_for_process``) and the batches staged onto its data
    sharding. ``preprocess_fn`` is the step's preprocess (default:
    :func:`preprocess`)."""
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.codecs import image_routes
    from petastorm_tpu_torch.models.train import make_train_step
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
    train_step = make_train_step(preprocess_fn=preprocess_fn or preprocess, preprocess_seed=SEED,
                                 graphed=graphed)
    losses = []
    first_batches = []
    seen_labels = []
    staged = []

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
        if rows_check is not None:
            staged.append((images, labels))
        if on_step is not None:
            on_step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    image_routes.reset()
    obs.get_registry().reset()
    obs.get_ring().clear()
    reset_launches()
    t0 = time.perf_counter()
    result = pipeline_duty_cycle(
        url, step_fn, lambda b: (b['image'], b['label']), batch_size=BATCH, steps=steps,
        warmup_steps=WARMUP_STEPS, reader_kwargs=kwargs,
        loader_kwargs={'shuffling_queue_capacity': SHUFFLE_CAPACITY, 'seed': SEED},
        telemetry=telemetry, **factory)
    wall_s = time.perf_counter() - t0
    launches = kernel_launches()
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
    check_launches(name, launches, WARMUP_STEPS + steps)
    if label_check is not None:
        label_check(torch.cat(seen_labels).cpu().numpy())
    if rows_check is not None:
        rows_check([key for images, labels in staged for key in _row_keys(images, labels)])
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


def check_graphed_losses(torch, name, graphed_losses, batches, preprocess_fn=None):
    """A fresh eager state from the seed trains on the graphed run's first
    staged batches, with the same preprocess (default: :func:`preprocess`)
    and so the same draws: its losses must be the graphed run's."""
    from petastorm_tpu_torch.models.train import make_train_step

    state = new_train_state(torch)
    step = make_train_step(preprocess_fn=preprocess_fn or preprocess, preprocess_seed=SEED)
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
    check_graphed_losses(torch, name, losses, runs['graphed'][2], kwargs.get('preprocess_fn'))
    return total, runs


class CropShapes(object):
    """``normalize_images`` to bf16 that keeps the shape of every batch it
    normalizes: what the model saw after the step's crop."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, images):
        from petastorm_tpu_torch.ops import normalize_images

        self.shapes.add(tuple(images.shape))
        return normalize_images(images, IMAGENET_MEAN, IMAGENET_STD)


def phase_raw_crop(torch, url, raw_runs):
    """``raw``'s trainer with a step that draws more than the flip mask:
    ``RandomCropFlip(CROP_SIZE, CROP_SIZE, then=normalize)`` crops each
    160 px image at offsets drawn per image, flips it and normalizes it (the
    Triton kernel), all inside the step; the graphed step copies the offsets
    and the mask into buffers of their own before each replay. Both step
    kinds, the graph check on the same batches and the same draws, and a
    ``raw_crop_vs`` line beside ``raw``'s numbers. Returns the launches."""
    from petastorm_tpu_torch.ops import RandomCropFlip

    shapes = CropShapes()
    total, runs = run_path_both_ways(
        torch, 'raw_crop', url, check_batch,
        preprocess_fn=RandomCropFlip(CROP_SIZE, CROP_SIZE, then=shapes))
    if shapes.shapes != {(BATCH, CROP_SIZE, CROP_SIZE, 3)}:
        raise AssertionError('raw_crop: the model saw batches of {}, not {}'.format(
            sorted(shapes.shapes), (BATCH, CROP_SIZE, CROP_SIZE, 3)))
    emit({'phase': 'raw_crop_vs', 'crop': [IMAGE_SIZE, CROP_SIZE],
          'raw_crop': path_numbers(runs), 'raw': path_numbers(raw_runs),
          'normalize_launches': total['normalize']})
    return total


#: the explorer's budgets in race_checks: the CLI's defaults
RACE_SCHEDULES = 300
RACE_DFS_BUDGET = 100
RACE_MAX_PREEMPTIONS = 2
#: the seeded defects the explorer must catch, and what it must report
RACE_DEFECTS = {'torn_counter': 'race on', 'prefix_ventilator_flags': 'race on',
                'abba_deadlock': 'deadlock:'}


#: rows the throughput tool warms up on and measures on the thread pool:
#: 64 and 1024 batches of the raw store (its 1024 rows 4 and 64 times
#: over), so each run measures for 1-3 s at 20,000-70,000 samples/s
THROUGHPUT_WARMUP_ROWS = 64 * BATCH
THROUGHPUT_MEASURE_ROWS = 1024 * BATCH
#: on the process pool: 256 batches of warm-up take each of 8 workers
#: through its 64 MiB ring about 2.5 times (13 row groups of 4.9 MB a lap),
#: then 512 measured batches
THROUGHPUT_PROCESS_WARMUP_ROWS = 256 * BATCH
THROUGHPUT_PROCESS_MEASURE_ROWS = 512 * BATCH
#: the ``--trace-out`` run checks the trace, not a rate: a short window
#: keeps the trace small
THROUGHPUT_TRACE_ROWS = 16 * BATCH
#: the result line both packages' tools print
THROUGHPUT_LINE = re.compile(r'^([\d.]+) samples/sec; ([\d.]+) MB RSS; ([\d.]+)% CPU'
                             r'(?:; ([\d.]+)% input stall)?$')


def _throughput_cli(url, warmup_rows, measure_rows, *options):
    """``python -m petastorm_tpu_torch.tools.throughput`` on ``url`` with
    the smoke's batch and a worker per core, as a user runs it. Returns the
    numbers of its result line, its stall report's bottleneck, its window
    (rows warmed up on and measured, and the measured seconds the rate
    implies), its seconds (the interpreter's start included) and its output
    lines."""
    device = [] if DEVICE_TYPE == 'cuda' else ['--device', DEVICE_TYPE]
    argv = [sys.executable, '-m', 'petastorm_tpu_torch.tools.throughput', url,
            '-m', str(warmup_rows), '-n', str(measure_rows),
            '-w', str(os.cpu_count() or 1), '--batch-size', str(BATCH)] + device + list(options)
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    lines = out.stdout.splitlines()
    match = THROUGHPUT_LINE.match(lines[0]) if lines else None
    if out.returncode != 0 or match is None:
        raise AssertionError('throughput_checks: {} exited {}:\n{}\n{}'.format(
            ' '.join(argv[2:]), out.returncode, out.stdout, out.stderr))
    bottleneck = [line.split(':', 1)[1].strip() for line in lines
                  if line.strip().startswith('bottleneck:')]
    rate = float(match.group(1))
    return {'samples_per_sec': rate, 'rss_mb': float(match.group(2)),
            'cpu_percent': float(match.group(3)),
            'stall': None if match.group(4) is None else float(match.group(4)) / 100,
            'bottleneck': bottleneck[0] if bottleneck else None,
            'warmup_rows': warmup_rows, 'measure_rows': measure_rows,
            'measure_s': measure_rows / rate, 'seconds': seconds}, lines


def _staged_devices(throughput, url):
    """Run ``reader_throughput(read_method='torch')`` on ``url`` in this
    process with its prefetcher wrapped, and return the devices of every
    tensor it staged and its result."""
    import petastorm_tpu_torch.torch as port_torch

    real = port_torch.prefetch_to_device
    devices = set()

    def recording(iterator, device=None, size=2):
        batches = real(iterator, device, size=size)
        try:
            for batch in batches:
                devices.update(t.device.type for t in batch.values())
                yield batch
        finally:
            batches.close()

    port_torch.prefetch_to_device = recording  # what reader_throughput imports
    try:
        result = throughput.reader_throughput(
            url, read_method='torch', warmup_cycles=THROUGHPUT_WARMUP_ROWS,
            measure_cycles=THROUGHPUT_MEASURE_ROWS, workers_count=os.cpu_count() or 1,
            batch_size=BATCH, device=None if DEVICE_TYPE == 'cuda' else DEVICE_TYPE)
    finally:
        port_torch.prefetch_to_device = real
    return devices, result


def phase_throughput_checks(url, raw_runs):
    """The reader without a train step, through the port's throughput tool
    (``python -m petastorm_tpu_torch.tools.throughput``) on the raw store:
    rows (``-d python``, in a fresh process), host batches (``-d
    columnar``) and batches staged on the card (``-d torch``), on the
    thread pool, then ``-d torch`` on the process pool, each measured for
    seconds after a warm-up (``THROUGHPUT_*_ROWS``); a short ``-d python
    --trace-out`` run whose trace must parse and hold events (its rate, at
    the ``spans`` level over 16 batches, is not reported); one in-process
    call checks that the tool stages onto the card. Beside each run's
    samples/s, MB RSS, CPU%, stall and window: ``torch`` over ``columnar``
    (what staging costs) and ``torch`` over ``raw``'s graphed examples/s of
    this call (the reader's headroom over the step). Each subprocess's
    seconds include its interpreter's start."""
    from petastorm_tpu_torch.tools import throughput

    t0 = time.perf_counter()
    runs = {}
    thread_window = (THROUGHPUT_WARMUP_ROWS, THROUGHPUT_MEASURE_ROWS)
    runs['python'], _ = _throughput_cli(url, *thread_window, '-d', 'python', '--fresh-process')
    runs['columnar'], _ = _throughput_cli(url, *thread_window, '-d', 'columnar')
    runs['torch'], _ = _throughput_cli(url, *thread_window, '-d', 'torch')
    runs['torch_process'], _ = _throughput_cli(
        url, THROUGHPUT_PROCESS_WARMUP_ROWS, THROUGHPUT_PROCESS_MEASURE_ROWS,
        '-d', 'torch', '-p', 'process')
    trace_path = os.path.join(BUILD_DIR, 'trace_throughput.json')
    trace_run, lines = _throughput_cli(url, THROUGHPUT_TRACE_ROWS, THROUGHPUT_TRACE_ROWS,
                                       '-d', 'python', '--trace-out', trace_path)
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    written = int(lines[-1].split()[1]) if lines[-1].startswith('wrote ') else None
    if not events or written != len(events):
        raise AssertionError('throughput_checks: the trace holds {} events, the tool wrote '
                             '{}'.format(len(events), lines[-1]))
    for name, run in runs.items():
        staged = name.startswith('torch')
        if staged != (run['stall'] is not None) or \
                (name != 'python') != (run['bottleneck'] is not None):
            raise AssertionError('throughput_checks: {} reported {}'.format(name, run))
        if staged and not 0.0 <= run['stall'] <= 1.0:
            raise AssertionError('throughput_checks: {} stall {}'.format(name, run['stall']))
    devices, result = _staged_devices(throughput, url)
    if devices != {DEVICE_TYPE} or result.samples != THROUGHPUT_MEASURE_ROWS:
        raise AssertionError('throughput_checks: the in-process torch method staged onto {} '
                             '({} samples)'.format(sorted(devices), result.samples))
    raw_graphed = raw_runs['graphed'][3].samples_per_second
    emit({'phase': 'throughput_checks', 'store': 'raw', 'batch': BATCH,
          'workers': os.cpu_count() or 1, 'runs': runs,
          'in_process_torch': {'staged_on': sorted(devices),
                               'samples_per_sec': result.samples_per_second,
                               'rss_mb': result.memory_rss_mb,
                               'cpu_percent': result.cpu_percent,
                               'stall': result.input_stall_fraction,
                               'measure_s': result.duration_s},
          'trace_events': len(events), 'trace_run_seconds': trace_run['seconds'],
          'raw_graphed_examples_per_sec': raw_graphed,
          'torch_over_columnar': runs['torch']['samples_per_sec'] /
          runs['columnar']['samples_per_sec'],
          'torch_over_raw_graphed': runs['torch']['samples_per_sec'] / raw_graphed,
          'seconds': time.perf_counter() - t0})


def _race_cli(names, options=(), schedule=None):
    """``python -m petastorm_tpu_torch.analysis.schedule.cli explore`` of the
    scenarios ``names`` with ``options`` (and ``PSTPU_SCHEDULE=schedule``)
    in a subprocess. Returns its exit code and its reports, one per
    scenario in order: ``(name, lines, seconds)``, the seconds from the
    previous report (the first's from the start, the interpreter's start
    included)."""
    env = dict(os.environ, PYTHONUNBUFFERED='1')  # each report as it is printed
    env.pop('PSTPU_SCHEDULE', None)
    if schedule is not None:
        env['PSTPU_SCHEDULE'] = schedule
    proc = subprocess.Popen([sys.executable, '-m', 'petastorm_tpu_torch.analysis.schedule.cli',
                             'explore'] + list(names) + list(options), cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    reports, last = [], time.perf_counter()
    try:
        for line in proc.stdout:
            line = line.rstrip('\n')
            head = line.split(':', 1)[0]
            if head in names and len(reports) < len(names) \
                    and (not reports or reports[-1][0] != head):
                now = time.perf_counter()
                reports.append([head, [line], now - last])
                last = now
            elif reports:
                reports[-1][1].append(line)
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stderr = proc.stderr.read()
    proc.stderr.close()
    proc.stdout.close()
    if [r[0] for r in reports] != list(names):
        raise AssertionError('race_checks: the CLI reported {} for {} (rc {}):\n{}'.format(
            [r[0] for r in reports], names, rc, stderr))
    return rc, [tuple(r) for r in reports]


def _race_failure(lines):
    """A failure report's lines from the first finding to ``schedule:``
    (object addresses in a deadlock's resources, which differ between
    processes, written ``0x?``), and its replay schedule."""
    schedule = lines[-1].split('PSTPU_SCHEDULE=', 1)[1]
    return [re.sub(r' at 0x[0-9a-f]+', ' at 0x?', line) for line in lines[1:-1]], schedule


def phase_race_checks():
    """Host only (no device work): the port's interleaving explorer, through
    its CLI, over the five component scenarios at the CLI's defaults in one
    process (every one clean; the seconds of each, the interpreter's start
    in the first's); the three seeded defects in another (each caught); and
    each defect's failure replayed through ``PSTPU_SCHEDULE`` in a process
    of its own, its report the recorded one."""
    from petastorm_tpu_torch.analysis.schedule.scenarios import SCENARIOS

    budget = ['--schedules', str(RACE_SCHEDULES), '--dfs-budget', str(RACE_DFS_BUDGET),
              '--max-preemptions', str(RACE_MAX_PREEMPTIONS)]
    rc, reports = _race_cli(sorted(SCENARIOS), budget)
    scenarios = {}
    for name, lines, seconds in reports:
        counts = [int(x) for x in re.findall(r'\d+', lines[0].split(': ok', 1)[-1])]
        scenarios[name] = {'report': lines[0], 'seconds': seconds}
        if len(lines) != 1 or len(counts) != 3 or counts[1] < RACE_SCHEDULES or counts[2] < 1:
            raise AssertionError('race_checks: {} is not clean at the CLI defaults:\n{}'.format(
                name, '\n'.join(lines)))
        scenarios[name].update(schedules=counts[0], random=counts[1], dfs=counts[2])
    if rc != 0:
        raise AssertionError('race_checks: the clean scenarios exited {}'.format(rc))
    rc, reports = _race_cli(list(RACE_DEFECTS), budget)
    if rc != 1:
        raise AssertionError('race_checks: the seeded defects exited {}, not 1'.format(rc))
    defects = {}
    for name, lines, seconds in reports:
        if RACE_DEFECTS[name] not in '\n'.join(lines):
            raise AssertionError('race_checks: the explorer did not catch {}:\n{}'.format(
                name, '\n'.join(lines)))
        report, schedule = _race_failure(lines)
        replay_rc, replayed = _race_cli([name], schedule=schedule)
        replay_report, replay_schedule = _race_failure(replayed[0][1])
        identical = replay_rc == 1 and replay_schedule == schedule and replay_report == report
        defects[name] = {'caught': lines[0], 'findings': report[:-1], 'schedule': schedule,
                         'seconds': seconds, 'replay_rc': replay_rc,
                         'replay_identical': identical, 'replay_s': replayed[0][2]}
        if not identical:
            raise AssertionError('race_checks: PSTPU_SCHEDULE={} did not replay {}\'s failure:'
                                 '\n{}\nagainst\n{}'.format(schedule, name,
                                                             '\n'.join(replayed[0][1]),
                                                             '\n'.join(lines)))
    emit({'phase': 'race_checks', 'device': 'none (host only: the explorer runs on the CPU)',
          'budget': {'schedules': RACE_SCHEDULES, 'dfs_budget': RACE_DFS_BUDGET,
                     'max_preemptions': RACE_MAX_PREEMPTIONS},
          'scenarios': scenarios, 'defects': defects,
          'seconds': sum(v['seconds'] for v in scenarios.values()) +
          sum(v['seconds'] + v['replay_s'] for v in defects.values())})


#: the port's PT400 fixtures (``ops/fixture.py`` under ``bad/`` and
#: ``clean/``): each ``<kind>_block(graph, x)`` captures with
#: ``torch.cuda.graph``, each ``<kind>_step(x)`` through its
#: ``graph_<kind>_step(x)`` and ``torch.cuda.make_graphed_callables``
PT400_FIXTURES = os.path.join(ROOT, 'tests', 'torch_lint_fixtures', 'PT400')
#: the capture probes' input: a float32 tensor of this shape, from SEED
PROBE_SHAPE = (64, 1024)
#: a probe's own time limit (each is one interpreter, torch and one capture)
PROBE_TIMEOUT_S = 300
#: the time limit of each whole-tree pass of the linter
LINT_TIMEOUT_S = 600


def _probe_fixture(side):
    import importlib.util
    path = os.path.join(PT400_FIXTURES, side, 'ops', 'fixture.py')
    spec = importlib.util.spec_from_file_location('pt400_{}_fixture'.format(side), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _probe_eager(torch, fixture, name, x):
    """The probe's function called without a capture: a ``<kind>_block``
    runs its block's body with ``torch.cuda.graph`` swapped for a null
    context."""
    fn = getattr(fixture, name)
    if name.endswith('_step'):
        out = fn(x)
    else:
        graph = torch.cuda.graph
        torch.cuda.graph = lambda *args, **kwargs: contextlib.nullcontext()
        try:
            out = fn(None, x)
        finally:
            torch.cuda.graph = graph
    torch.cuda.synchronize()
    return out.clone()


def _probe_replays(torch, fixture, name, x, count=2):
    """Capture the probe's function once, then replay it ``count`` times:
    the output after each replay."""
    outs = []
    if name.endswith('_step'):
        graphed = getattr(fixture, 'graph_' + name)(x)
        for _ in range(count):
            outs.append(graphed(x).clone())
    else:
        graph = torch.cuda.CUDAGraph()
        out = getattr(fixture, name)(graph, x)
        for _ in range(count):
            graph.replay()
            torch.cuda.synchronize()
            outs.append(out.clone())
    torch.cuda.synchronize()
    return outs


def capture_probe(side, name):
    """One PT400 fixture function on the card, in a process of its own:
    two eager calls, and one capture replayed twice (or the capture's
    error). Prints one JSON line.

    - a ``sync`` probe must fail its capture;
    - a ``clock`` or ``host_rng`` probe must capture, its two replays equal
      where its two eager calls differ (the host value froze at capture);
    - a ``reseed`` probe must fail its capture, or be frozen: its eager
      calls equal (each reseeds) where its replays differ (no replay
      reseeds);
    - a clean probe must capture, its first replay within
      ``REPLAY_LOSS_TOL`` of its eager call."""
    import torch

    fixture = _probe_fixture(side)
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    x = torch.randn(PROBE_SHAPE, device='cuda', generator=gen)
    eager = [_probe_eager(torch, fixture, name, x) for _ in range(2)]
    result = {'probe': name, 'side': side, 'kind': name.rsplit('_', 1)[0] if side == 'bad'
              else 'clean', 'form': 'make_graphed_callables' if name.endswith('_step')
              else 'torch.cuda.graph', 'eager_calls_differ': not torch.equal(*eager)}
    try:
        replays = _probe_replays(torch, fixture, name, x)
    except Exception as exc:  # noqa: BLE001 - the symptom under test: reported, then judged
        message = str(exc).strip()
        result.update(captured=False, error='{}: {}'.format(
            type(exc).__name__, message.splitlines()[0][:200] if message else ''))
    else:
        result.update(captured=True, replays_equal=torch.equal(*replays),
                      max_abs_err=float((replays[0] - eager[0]).abs().max()))
    kind = result['kind']
    if kind == 'clean':
        ok = result['captured'] and result['max_abs_err'] <= REPLAY_LOSS_TOL
    elif kind == 'sync':
        ok = not result['captured']
    elif kind in ('clock', 'host_rng'):
        ok = result['captured'] and result['replays_equal'] and result['eager_calls_differ']
    else:
        ok = not result['captured'] or (not result['eager_calls_differ']
                                        and not result['replays_equal'])
    result['symptom_shown'] = bool(ok)
    emit(result)


def _start_cli(module, *args):
    """``python -m <module> args`` from the checkout's root, started."""
    return subprocess.Popen([sys.executable, '-m', module] + list(args), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, t0, timeout):
    """A started process's output, exit code and seconds since ``t0``."""
    out, err = proc.communicate(timeout=timeout)
    return out, err, proc.returncode, time.perf_counter() - t0


def _flagged_probes(side):
    """The PT400 fixture's probe functions, each with the codes the port's
    linter reports inside it."""
    import ast

    from petastorm_tpu_torch.analysis import run_analysis

    root = os.path.join(PT400_FIXTURES, side)
    with open(os.path.join(root, 'ops', 'fixture.py')) as f:
        functions = [n for n in ast.parse(f.read()).body if isinstance(n, ast.FunctionDef)]
    probes = {fn.name: [] for fn in functions
              if fn.name.endswith(('_block', '_step')) and not fn.name.startswith('graph_')}
    for finding in run_analysis([root]):
        for fn in functions:
            if fn.lineno <= finding.line <= fn.end_lineno and fn.name in probes:
                probes[fn.name].append(finding.code)
    return probes


def phase_lint_checks():
    """The port's static linter. Host work, apart from the capture probes:
    the CLI over the installed port package (``--format json`` and
    ``--format sarif``: exit 0, the open and suppressed findings by code,
    the SARIF document parsed); the race CLI's ``lint`` mode (the PT13xx
    pass: exit 0); then PT400 held against real captures: each function of
    the port's PT400 fixtures is flagged (``bad``) or not (``clean``) by the
    linter, and captured on the card in a process of its own
    (:func:`capture_probe`; a capture left broken cannot reach later
    phases), all at once."""
    import petastorm_tpu_torch

    target = os.path.dirname(os.path.abspath(petastorm_tpu_torch.__file__))
    procs = {}
    try:
        # the three whole-tree passes and the probes run at once
        t0 = time.perf_counter()
        for name, module, args in (
                ('json', 'petastorm_tpu_torch.analysis', ('--format', 'json')),
                ('sarif', 'petastorm_tpu_torch.analysis', ('--format', 'sarif')),
                ('race_lint', 'petastorm_tpu_torch.analysis.schedule.cli', ('lint',))):
            procs[name] = _start_cli(module, *args)
        flagged = {side: _flagged_probes(side) for side in ('bad', 'clean')}
        for side, names in flagged.items():
            wrong = {name: codes for name, codes in names.items()
                     if codes != (['PT400'] if side == 'bad' else [])}
            if not names or wrong:
                raise AssertionError('lint_checks: PT400 on the {} fixture: {}'.format(
                    side, wrong or 'no probe'))
        t_probes = time.perf_counter()
        for side, names in flagged.items():
            for name in names:
                procs[(side, name)] = subprocess.Popen(
                    [sys.executable, '-c', 'import sys, chip_smoke; '
                     'chip_smoke.capture_probe(sys.argv[1], sys.argv[2])', side, name],
                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        runs = {name: _finish(procs[name], t0, LINT_TIMEOUT_S)
                for name in ('json', 'sarif', 'race_lint')}
        probes = {}
        for side, names in flagged.items():
            for name in names:
                out, err, rc, _ = _finish(procs[(side, name)], t_probes, PROBE_TIMEOUT_S)
                lines = [line for line in out.splitlines() if line.startswith('{')]
                if not lines:
                    raise AssertionError('lint_checks: the {} probe {} printed no result '
                                         '(rc {}):\n{}'.format(side, name, rc, err[-4000:]))
                probes[name] = json.loads(lines[-1])
    finally:
        for child in procs.values():
            if child.poll() is None:
                child.kill()
                child.wait()
    for name, (out, err, rc, _) in runs.items():
        if rc != 0:
            raise AssertionError('lint_checks: {} over {} exited {}:\n{}{}'.format(
                name, target, rc, out[-4000:], err[-4000:]))
    records = [json.loads(line) for line in runs['json'][0].splitlines()]
    by_status = collections.defaultdict(collections.Counter)
    for record in records:
        by_status[record['status']][record['rule']] += 1
    try:
        doc = json.loads(runs['sarif'][0])
        sarif_results = len(doc['runs'][0]['results'])
        sarif_parses = doc['version'] == '2.1.0' and sarif_results == len(records)
    except (ValueError, KeyError, IndexError):
        sarif_results, sarif_parses = None, False
    if not sarif_parses:
        raise AssertionError('lint_checks: the --format sarif output does not parse as the '
                             'findings\' SARIF document')
    probes_s = time.perf_counter() - t_probes
    missed = sorted(name for name, result in probes.items() if not result['symptom_shown'])
    emit({'phase': 'lint_checks', 'device': 'the capture probes only (the linter is host work)',
          'target': target, 'json_s': runs['json'][3], 'sarif_s': runs['sarif'][3],
          'race_lint_s': runs['race_lint'][3],
          'open': dict(by_status['open']), 'suppressed': {
              status: dict(counts) for status, counts in by_status.items() if status != 'open'},
          'sarif_parses': sarif_parses, 'sarif_results': sarif_results,
          'race_lint': runs['race_lint'][0].strip().splitlines()[-1:],
          'probes': probes, 'probes_s': probes_s, 'seconds': time.perf_counter() - t0,
          'card': nvidia_smi_line()})
    if missed:
        raise AssertionError('lint_checks: no symptom under a real capture: {}'.format(missed))


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


def spawn_elastic_host(url, coord, host, out_dir, epochs=ELASTIC_HOST_EPOCHS):
    """One pod host: ``python -m petastorm_tpu_torch.elastic._hostproc``
    reading ``epochs`` epochs of the store's labels (no torch, no device);
    its log and events go to ``out_dir``."""
    cmd = [sys.executable, '-m', 'petastorm_tpu_torch.elastic._hostproc', '--url', url,
           '--coord', coord, '--host', host, '--out', os.path.join(out_dir, host + '.jsonl'),
           '--field', 'label', '--seed', str(SEED), '--lease-s', str(ELASTIC_LEASE_S),
           '--sleep-per-row', str(ELASTIC_SLEEP_PER_ROW),
           '--num-epochs', str(epochs),
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
    from petastorm_tpu_torch.models.resnet import Conv
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
    # PyTorch's own convolutions return NCHW; this process's batch norms
    # run the kernels, which take channels last, as cuDNN returns it (the
    # ranks' batch norms are synced and take any layout)
    for module in state.model.modules():
        if isinstance(module, Conv):
            module.register_forward_hook(
                lambda mod, args, out: out.contiguous(memory_format=torch.channels_last))
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
    bit-reproducible). Returns the kernel launches and the first loss."""
    import io
    import pickle

    from petastorm_tpu_torch import make_batch_reader
    from petastorm_tpu_torch.models.train import make_train_step
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

    reset_launches()
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
    launches = kernel_launches()
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
    check_launches('plain_resume', launches, 2 * RESUME_STEPS)
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
    from petastorm_tpu_torch.workers import ProcessPoolOptions
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups

    items = len(load_row_groups(raw_url))
    keys = collections.Counter(range(ROWS))
    total = collections.Counter()
    runs = {}
    process = ProcessPoolOptions(ring_bytes=ring, transport='shm')
    for name, pool_name, pool_kwargs in (
            ('raw_process', 'process', {'reader_pool_type': process, 'zero_copy': True}),
            ('raw', 'thread', {'reader_pool_type': 'thread'})):
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
        runs[name] = {'pool': pool_name,
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
    two same-seed packed runs are bit-exact. Returns the store's URL and
    its rows' tokens."""
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
    return url, rows


FLIGHT_STEPS = 6


def flight_child(url, ring, run_dir):
    """The flight checks' child process: ``raw_process`` (eager, 3 + 6
    steps) with its flight files in ``run_dir``; after the warm-up it lists
    the files and prints them with the pids of this process and its workers
    as one JSON line. Called by :func:`phase_flight_checks`."""
    import torch

    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.workers import ProcessPoolOptions

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

    kwargs = {'reader_pool_type': ProcessPoolOptions(ring_bytes=ring, transport='shm'),
              'zero_copy': True}
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


#: ``raw_chaos``: ``raw_process``'s reader (zero-copy on the shm rings) for
#: one epoch under the chaos matrix of the fault-tolerance tests and
#: ``bench_scaling.py --chaos --protocol-monitor``: a pool of 8 workers, the
#: protocol monitor armed, ``on_error='retry'``, and a plan that SIGKILLs the
#: worker of one row group, SIGSEGVs the worker of another and fails a third
#: once
CHAOS_WORKERS = 8
#: the positions, in the seed's first-epoch ventilation order, of the row
#: groups killed, segfaulted and failed once: all among the first
#: ``CHAOS_WORKERS + 2`` items, which the ventilator dispatches at the start,
#: so every fault fires inside the 3 + 10 steps
CHAOS_POSITIONS = (('kill', 1), ('segv', 4), ('error', 7))


def chaos_fault_items(url):
    """``{'kill': a, 'segv': b, 'error': c}``: piece indices at
    :data:`CHAOS_POSITIONS` of the seed's first-epoch ventilation order
    (``np.random.default_rng(SEED).permutation`` of the row groups, as the
    ventilator draws it), checked against the order a dummy-pool reader of
    the same seed delivers, and that order."""
    from petastorm_tpu_torch import make_reader

    groups = ROWS // ROWS_PER_ROW_GROUP
    order = [int(i) for i in np.random.default_rng(SEED).permutation(groups)]
    by_labels = raw_row_groups()
    with make_reader(url, output='columnar', reader_pool_type='dummy', seed=SEED,
                     shuffle_row_groups=True, num_epochs=1, schema_fields=['label']) as reader:
        seen = [by_labels[tuple(b.label.tolist())].start // ROWS_PER_ROW_GROUP for b in reader]
    if seen != order:
        raise AssertionError('raw_chaos: the dummy reader delivers {}, the seed\'s order is '
                             '{}'.format(seen, order))
    return {kind: order[pos] for kind, pos in CHAOS_POSITIONS}, order


class ChaosRows(object):
    """The reader ``raw_chaos``'s loader iterates: records the rows of every
    block it yields (a raw row group, known by its label column) and, when
    the loader stops it, reads the rest of the epoch on the host before
    stopping the reader, recording those rows and the pool's counters and
    the monitor's snapshot at the drain; every other attribute is the
    reader's."""

    def __init__(self, reader):
        self._reader = reader
        self._groups = raw_row_groups()
        self.delivered = collections.Counter()
        self.drained = collections.Counter()
        self.pool_at_drain = None
        self.monitor_at_drain = None

    def __iter__(self):
        return self

    def __next__(self):
        block = next(self._reader)
        self.delivered.update(self._groups[tuple(block.label.tolist())])
        return block

    def stop(self):
        if self.pool_at_drain is None:
            for block in self._reader:
                self.drained.update(self._groups[tuple(block.label.tolist())])
            self.pool_at_drain = dict(self._reader._pool.diagnostics)
            self.monitor_at_drain = self._reader._pool.protocol_monitor.snapshot
        self._reader.stop()

    def __getattr__(self, name):
        return getattr(self._reader, name)


def _postmortem_segv(report):
    """The worker processes of a post-mortem that died of SIGSEGV, as
    ``(label, activity, file)``."""
    return [(p['label'], p['activity'], os.path.basename(p['path']))
            for p in report['processes']
            if p['label'].startswith('worker') and p['signal'] == 'SIGSEGV']


def phase_raw_chaos(torch, url, work_dir, process_runs):
    """``raw_chaos``: ``raw_process`` under injected faults. For each step
    kind, eager then graphed, a fresh one-epoch reader
    (``make_reader(output='columnar', reader_pool_type='process',
    zero_copy=True, shuffle_row_groups=True, seed=7, num_epochs=1,
    protocol_monitor=True, on_error='retry')``, 8 workers on shm rings
    sized for them), a fresh fault state directory and a fresh
    ``FaultPlan(kill_items=(a,), segv_items=(b,), error_items=(c,),
    error_times=1)`` (:func:`chaos_fault_items`), and a flight run
    directory of its own, trains ResNet-50 for 3 + 10 steps.
    Checks: every fault fired inside the 13 steps (its one-shot file exists
    at the last step); after the steps the rest of the epoch is read on the
    host (:class:`ChaosRows`) and each of the 1024 rows was delivered
    exactly once (the rows the loader read and the rows drained), the 832
    staged rows are distinct rows of the store; ``worker_restarts == 2``,
    ``items_requeued >= 3``, the error item failed once (its second shot's
    file absent), nothing quarantined, every publish in place on the shm
    transport; the monitor at the drain saw 16 items ventilated and
    completed, none in flight, and checked events (a ``ProtocolViolation``
    would have failed the run); the segfaulted worker's flight file
    (``.torch.bin``) names ``SIGSEGV`` and the ``worker.item`` stage, and
    ``diagnose --postmortem`` over the run directory reports the same.
    A ``chaos`` line per step kind and a ``raw_chaos_vs`` line beside
    ``raw_process``'s numbers of this call. Returns the launches."""
    from petastorm_tpu_torch import faults, make_reader
    from petastorm_tpu_torch.observability import blackbox
    from petastorm_tpu_torch.workers import ProcessPoolOptions

    items, order = chaos_fault_items(url)
    ring, needed = ring_bytes_for(_dev_shm()['free_bytes'], CHAOS_WORKERS, raw_payload_bytes(),
                                  ROWS_PER_ROW_GROUP)
    keys = store_row_keys()
    groups = ROWS // ROWS_PER_ROW_GROUP
    total = collections.Counter()
    results = {}
    runs = {}
    for graphed in (False, True):
        kind = 'graphed' if graphed else 'eager'
        state_dir = tempfile.mkdtemp(prefix='chaos_{}_'.format(kind), dir=work_dir)
        flight_dir = os.path.join(BUILD_DIR, 'flight', 'chaos_' + kind)
        shutil.rmtree(flight_dir, ignore_errors=True)
        readers = []
        fired_at_last_step = {}
        shots = {'kill': 'kill_{}'.format(items['kill']), 'segv': 'segv_{}'.format(items['segv']),
                 'error': 'err_{}_0'.format(items['error'])}

        def factory(url, **kwargs):
            kwargs.update(num_epochs=1, output='columnar')
            reader = ChaosRows(make_reader(url, **kwargs))
            readers.append(reader)
            return reader

        def on_step():
            steps = fired_at_last_step.setdefault('steps', 0) + 1
            fired_at_last_step['steps'] = steps
            if steps == WARMUP_STEPS + STEPS:
                fired_at_last_step.update({k: os.path.exists(os.path.join(state_dir, v))
                                           for k, v in shots.items()})

        staged = []
        # the run's flight files, the workers' included, in a directory of
        # their own: the post-mortem below reads this run alone
        blackbox.disable()
        faults.install(faults.FaultPlan(kill_items=(items['kill'],),
                                        segv_items=(items['segv'],),
                                        error_items=(items['error'],), error_times=1,
                                        state_dir=state_dir))
        try:
            with _env(PSTPU_FLIGHT_DIR=flight_dir):
                launches, _, _, batches, result, losses = run_path(
                    torch, 'raw_chaos', url, check_batch, graphed=graphed, on_step=on_step,
                    reader_factory=factory, rows_check=staged.extend, reader_kwargs={
                        'reader_pool_type': ProcessPoolOptions(
                            ring_bytes=ring, transport='shm', results_timeout_s=120),
                        'workers_count': CHAOS_WORKERS, 'zero_copy': True,
                        'protocol_monitor': True, 'on_error': 'retry'})
        finally:
            faults.uninstall()
            blackbox.disable()
        total.update(launches)
        runs[kind] = (batches, losses)
        results[kind] = result
        (reader,) = readers
        rows = reader.delivered + reader.drained
        staged_keys = collections.Counter(staged)
        pool, monitor = reader.pool_at_drain, reader.monitor_at_drain
        second_shot = os.path.exists(os.path.join(state_dir, 'err_{}_1'.format(items['error'])))
        report = blackbox.postmortem_report(flight_dir)
        segv = _postmortem_segv(report)
        cli = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.observability.diagnose',
                              '--postmortem', flight_dir, '--json'], cwd=ROOT, timeout=120,
                             capture_output=True, text=True,
                             env=dict(os.environ, PSTPU_FLIGHT='0'))
        cli_segv = _postmortem_segv(json.loads(cli.stdout)) if cli.returncode == 0 else None
        line = {'phase': 'chaos', 'path': 'raw_chaos', 'step': kind,
                'workers': CHAOS_WORKERS, 'ring_bytes': ring, 'ring_bytes_needed': needed,
                'fault_items': items, 'ventilation_order': order,
                'fired_by_last_step': fired_at_last_step, 'error_second_shot': second_shot,
                'examples_per_sec': result.samples_per_second,
                'median_step_ms': result.extra['median_step_ms'],
                'step_ms': result.extra['step_ms'],
                'input_stall_fraction': result.input_stall_fraction,
                'bottleneck': (result.extra['stall'] or {}).get('bottleneck'),
                'rows_read_by_loader': sum(reader.delivered.values()),
                'rows_drained': sum(reader.drained.values()),
                'rows_staged': sum(staged_keys.values()),
                'worker_restarts': pool['worker_restarts'],
                'items_requeued': pool['items_requeued'],
                'items_quarantined': pool['items_quarantined'],
                'publishes': {k: pool.get(k) for k in ('publish_inplace', 'publish_ring',
                                                       'publish_blob', 'publish_zmq')},
                'monitor_at_drain': monitor, 'postmortem_segv': segv,
                'postmortem_cause': report['probable_cause'],
                'diagnose_postmortem_rc': cli.returncode, 'diagnose_postmortem_segv': cli_segv}
        emit(line)
        fired = all(fired_at_last_step.get(k) for k in shots)
        exactly_once = rows == collections.Counter(range(ROWS))
        staged_ok = (sum(staged_keys.values()) == (WARMUP_STEPS + STEPS) * BATCH
                     and max(staged_keys.values()) == 1 and not set(staged_keys) - set(keys))
        pool_ok = (pool['worker_restarts'] == 2 and pool['items_requeued'] >= 3
                   and not pool['items_quarantined'] and not second_shot
                   and pool.get('transport') == 'shm' and pool.get('zero_copy')
                   and pool.get('publish_inplace') == groups
                   and not any(line['publishes'][k] for k in ('publish_ring', 'publish_blob',
                                                              'publish_zmq')))
        monitor_ok = (monitor['ventilated'] == monitor['completed'] == groups
                      and monitor['in_flight'] == [] and monitor['events_checked'] > 0)
        flight_ok = (len(segv) == 1 and segv[0][1] == 'worker.item'
                     and segv[0][2].endswith('.torch.bin') and cli_segv == segv)
        if not (fired and exactly_once and staged_ok and pool_ok and monitor_ok and flight_ok):
            raise AssertionError('raw_chaos ({}): fired {}, rows once {}, staged {}, pool {}, '
                                 'monitor {}, flight {}: {}'.format(
                                     kind, fired, exactly_once, staged_ok, pool_ok, monitor_ok,
                                     flight_ok, line))
        shutil.rmtree(state_dir, ignore_errors=True)
    check_graphed_losses(torch, 'raw_chaos', runs['graphed'][1], runs['graphed'][0])
    check_no_leftovers()

    def numbers(result):
        return {'examples_per_sec': result.samples_per_second,
                'median_step_ms': result.extra['median_step_ms'],
                'input_stall_fraction': result.input_stall_fraction,
                'bottleneck': (result.extra['stall'] or {}).get('bottleneck')}

    emit({'phase': 'raw_chaos_vs',
          'raw_process': {k: numbers(v[3]) for k, v in process_runs.items()},
          'raw_chaos': {k: numbers(v) for k, v in results.items()}})
    return total


#: ``monitor_checks``' model-checker runs: the CLI's arguments and the
#: canonical states each explores (the JAX checker's counts of the same
#: scopes); the pool's default scope (1.3 M states) stays in the CPU tests
MODELCHECK_RUNS = {
    'tiny': (['--workers', '2', '--items', '2', '--crashes', '1'], 1756),
    'error_scope': (['--workers', '2', '--items', '2', '--crashes', '1', '--retries', '1',
                     '--errors', '2', '--policy', 'skip'], 6619),
    'serve_default': (['--serve'], 943900),
    'elastic_default': (['--elastic'], 172641),
}
#: ``monitor_checks``' elastic pod: epochs each host reads before it exits
MONITOR_POD_EPOCHS = 3


def _start_modelchecks():
    """The model-checker CLI on each of :data:`MODELCHECK_RUNS`, all started
    at once (each is one CPU-bound process)."""
    cmd = [sys.executable, '-m', 'petastorm_tpu_torch.analysis.protocol.modelcheck', '--json',
           '--budget-s', '600']
    return {name: (subprocess.Popen(cmd + args, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True), time.perf_counter())
            for name, (args, _) in MODELCHECK_RUNS.items()}


def _finish_modelchecks(procs):
    out = {}
    for name, (proc, t0) in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError('modelcheck {} exited {}: {}'.format(name, proc.returncode,
                                                                      stderr[-2000:]))
        doc = json.loads(stdout)
        out[name] = {'states': doc['states'], 'transitions': doc['transitions'],
                     'exhausted': doc['exhausted'], 'violation': doc['violation'],
                     'seconds': seconds}
        if doc['states'] != MODELCHECK_RUNS[name][1] or not doc['exhausted'] or doc['violation']:
            raise AssertionError('modelcheck {}: {}'.format(name, out[name]))
    return out


def _monitored_serve(raw_url, work_dir):
    """Two tenants of an in-process serve daemon, the daemon's monitor and
    both consumers' armed by ``PSTPU_SERVE_MONITOR=1``, on ``serve_checks``'
    64 KiB ring over 30 epochs of the raw store's labels: one reads every
    batch and detaches, the other never reads, is evicted, and detaches."""
    from petastorm_tpu_torch.errors import ConsumerEvictedError
    from petastorm_tpu_torch.serve import ReaderService

    svc = ReaderService(os.path.join(work_dir, 'svc_monitor'), workers_count=2,
                        ring_bytes=SERVE_CHECK_RING, evict_block_s=SERVE_CHECK_EVICT_S,
                        idle_timeout_s=None)
    if svc.monitor is None:
        raise AssertionError('monitor_checks: PSTPU_SERVE_MONITOR=1 armed no daemon monitor')
    svc.start()
    kwargs = {'output': 'columnar', 'shuffle_row_groups': False,
              'num_epochs': SERVE_CHECK_EPOCHS, 'schema_fields': ['label']}
    from petastorm_tpu_torch import make_reader
    try:
        with make_reader(raw_url, serve=svc.service_dir, **kwargs) as fast, \
                make_reader(raw_url, serve=svc.service_dir, **kwargs) as slow:
            blocks = sum(1 for _ in fast)
            try:
                for _ in slow:
                    pass
                evicted = False
            except ConsumerEvictedError:
                evicted = True
            consumers = {'fast': fast._facade.monitor.events_checked,
                         'slow': slow._facade.monitor.events_checked}
        stats = svc.stats()
    finally:
        svc.shutdown()
    out = {'blocks': blocks, 'evicted': evicted, 'evictions': stats['evictions'],
           'daemon_events_checked': svc.monitor.events_checked,
           'consumer_events_checked': consumers}
    if (not evicted or stats['evictions'] != 1 or blocks != SERVE_CHECK_EPOCHS * ROWS // ROWS_PER_ROW_GROUP
            or not svc.monitor.events_checked or not consumers['fast']):
        raise AssertionError('monitor_checks: serve: {}'.format(out))
    return out


def _monitored_pod(url, work_dir):
    """An elastic pod of host processes, each inheriting
    ``PSTPU_ELASTIC_MONITOR=1`` (``raw_elastic``'s host script): ``h1`` and ``h2`` read
    :data:`MONITOR_POD_EPOCHS` epochs; ``h1`` is SIGKILLed 4 commits in and
    ``h3`` joins. Every survivor exits 0 (a violation would end it non-zero)
    with its monitor's events in its ``done`` line, and the scoreboard is
    exactly once."""
    from petastorm_tpu_torch.faults import HostChurnPlan, drive_host_churn

    pod_dir = tempfile.mkdtemp(prefix='monitor_pod_', dir=work_dir)
    coord = os.path.join(pod_dir, 'coord')
    procs, churn = {}, {}
    try:
        for host in ELASTIC_HOSTS:
            procs[host] = spawn_elastic_host(url, coord, host, pod_dir,
                                             epochs=MONITOR_POD_EPOCHS)

        def spawn_joiner():
            churn['wall'] = time.time()
            churn['epoch'], churn['inflight'], churn['done'] = _kill_epoch_inflight(
                coord, ELASTIC_KILL)
            return spawn_elastic_host(url, coord, ELASTIC_JOIN, pod_dir,
                                      epochs=MONITOR_POD_EPOCHS)

        timeline = drive_host_churn(coord, procs, HostChurnPlan(
            kill_host=ELASTIC_KILL, join_host=ELASTIC_JOIN, kill_after_commits=ELASTIC_KILL_AFTER),
            spawn_joiner=spawn_joiner, timeout_s=120)
        rcs = {host: proc.wait(timeout=180) for host, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    done = {}
    for host in rcs:
        with open(os.path.join(pod_dir, host + '.jsonl')) as f:
            for rec in map(json.loads, f):
                if rec['event'] == 'done':
                    done[host] = rec.get('monitor')
    pod = check_elastic_pod('monitor_checks', coord, ROWS // ROWS_PER_ROW_GROUP, churn)
    out = {'return_codes': rcs, 'killed': timeline['killed'], 'joined': timeline['joined'],
           'monitors': done, 'commits': pod['commits'], 'closed_epochs': pod['closed_epochs']}
    expected_rcs = {h: (-signal.SIGKILL if h == ELASTIC_KILL else 0) for h in rcs}
    survivors = [h for h in rcs if h != ELASTIC_KILL]
    if (rcs != expected_rcs or any(not (done.get(h) or {}).get('events_checked')
                                   for h in survivors)):
        raise AssertionError('monitor_checks: pod: {} {}'.format(
            out, {h: _host_log(pod_dir, h) for h in rcs}))
    shutil.rmtree(pod_dir, ignore_errors=True)
    return out


def phase_monitor_checks(raw_url, work_dir):
    """``monitor_checks`` (host only): the port's model checker through its
    CLI on the small scopes and the serve and elastic default scopes (their
    canonical state counts the JAX checker's, each exhausted clean), running
    while a serve daemon and an elastic pod run under their monitors
    (:func:`_monitored_serve`, :func:`_monitored_pod`)."""
    t0 = time.perf_counter()
    checks = _start_modelchecks()
    try:
        with _env(PSTPU_SERVE_MONITOR='1'):
            serve = _monitored_serve(raw_url, work_dir)
        with _env(PSTPU_ELASTIC_MONITOR='1'):
            pod = _monitored_pod(raw_url, work_dir)
        model = _finish_modelchecks(checks)
    finally:
        for proc, _ in checks.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    emit({'phase': 'monitor_checks', 'modelcheck': model, 'serve': serve, 'pod': pod,
          'seconds': time.perf_counter() - t0})
    check_no_leftovers()


#: ``diagnose_checks``: the pod's reader processes, each reading the raw
#: store's labels for this many epochs, sleeping this long a block: the slow
#: one's sleep is three times the card host's read of a block (about 30 ms),
#: so its rows/s fall under the pod report's straggler ratio (0.7 of the
#: median) whatever the host's read time
POD_READER_EPOCHS = 4
POD_FAST_SLEEP_S = 0.005
POD_SLOW_SLEEP_S = 0.1
#: ``diagnose --watch``: its interval and ticks
WATCH_INTERVAL_S = 0.5
WATCH_TICKS = 4


def pod_reader(url, path, host, sleep_s):
    """One reader process of ``diagnose_checks``' pod (``python -c 'import
    chip_smoke; chip_smoke.pod_reader(...)'``, no torch): reads the raw
    store's labels on the dummy pool, sleeping ``sleep_s`` a block, while a
    ``JsonlExporter`` stamped ``host`` writes its rows and wait seconds to
    ``path`` every 0.1 s."""
    from petastorm_tpu_torch import make_reader, observability as obs

    counts = {'rows_emitted': 0, 'reader_wait_s': 0.0}
    with make_reader(url, output='columnar', reader_pool_type='dummy', schema_fields=['label'],
                     num_epochs=POD_READER_EPOCHS) as reader:
        with obs.JsonlExporter(path, interval_s=0.1, host_key=host,
                               snapshot_fn=lambda: {'counters': dict(counts)}):
            it = iter(reader)
            while True:
                t0 = time.perf_counter()
                try:
                    block = next(it)
                except StopIteration:
                    break
                counts['reader_wait_s'] += time.perf_counter() - t0
                counts['rows_emitted'] += len(block.label)
                time.sleep(sleep_s)


def phase_diagnose_checks(raw_url, work_dir):
    """``diagnose_checks`` (the loaders stage on the card): a one-shot
    ``diagnose`` of the raw store (its stall report and seconds); ``diagnose
    --pod`` over the exports of two reader processes (:func:`pod_reader`),
    one slowed, which the report names as the straggler; ``diagnose --watch
    --json`` over the raw store as a subprocess, and ``python -m
    petastorm_tpu_torch.autotune.cli`` replaying its lines."""
    from petastorm_tpu_torch.observability import diagnose

    out = {'phase': 'diagnose_checks'}
    t0 = time.perf_counter()
    report, diag = diagnose.diagnose(raw_url, batch_size=BATCH, batches=20, pool_type='thread',
                                     workers_count=max(1, os.cpu_count() or 1),
                                     telemetry='counters')
    out['one_shot'] = {'seconds': time.perf_counter() - t0, 'stall_report': report,
                       'rows_emitted': diag.get('rows_emitted')}
    if diag.get('rows_emitted', 0) < 20 * BATCH or 'bottleneck' not in report:
        raise AssertionError('diagnose_checks: one-shot: {}'.format(out['one_shot']))

    pod_dir = os.path.join(work_dir, 'pod_exports')
    os.makedirs(pod_dir)
    env = dict(os.environ, PSTPU_FLIGHT='0')
    procs = {host: subprocess.Popen(
        [sys.executable, '-c', 'import chip_smoke; chip_smoke.pod_reader({!r}, {!r}, {!r}, {!r})'
         .format(raw_url, os.path.join(pod_dir, host + '.jsonl'), host, sleep_s)],
        cwd=ROOT, env=env) for host, sleep_s in (('fast', POD_FAST_SLEEP_S), ('slow', POD_SLOW_SLEEP_S))}
    try:
        rcs = {host: proc.wait(timeout=300) for host, proc in procs.items()}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    cli = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.observability.diagnose',
                          '--pod', pod_dir, '--json'], cwd=ROOT, env=env, timeout=120,
                         capture_output=True, text=True)
    pod = json.loads(cli.stdout)['pod'] if cli.returncode == 0 else None
    out['pod'] = {'return_codes': rcs, 'cli_rc': cli.returncode, 'report': pod}
    if (rcs != {'fast': 0, 'slow': 0} or pod is None or pod['straggler'] is None
            or pod['straggler']['host'] != 'slow'):
        raise AssertionError('diagnose_checks: pod: {} {}'.format(out['pod'], cli.stderr[-2000:]))

    t0 = time.perf_counter()
    watch = subprocess.run(
        [sys.executable, '-m', 'petastorm_tpu_torch.observability.diagnose', raw_url,
         '--watch', str(WATCH_INTERVAL_S), '--ticks', str(WATCH_TICKS), '--json',
         '--batch-size', str(BATCH), '-p', 'thread', '-w', str(max(1, os.cpu_count() or 1)),
         '--telemetry', 'counters'], cwd=ROOT, env=env, timeout=300, capture_output=True,
        text=True)
    watch_s = time.perf_counter() - t0
    ticks = [json.loads(line) for line in watch.stdout.splitlines() if line.startswith('{')]
    history = os.path.join(work_dir, 'watch.jsonl')
    with open(history, 'w') as f:
        f.writelines(json.dumps(tick) + '\n' for tick in ticks)
    replay = subprocess.run([sys.executable, '-m', 'petastorm_tpu_torch.autotune.cli', history,
                             '--workers', str(max(1, os.cpu_count() or 1)),
                             '--interval-s', str(WATCH_INTERVAL_S), '--json'],
                            cwd=ROOT, env=env, timeout=120, capture_output=True, text=True)
    proposal = json.loads(replay.stdout) if replay.returncode == 0 else None
    out['watch'] = {'rc': watch.returncode, 'seconds': watch_s, 'ticks': len(ticks),
                    'windows': [{k: t['window'].get(k) for k in (
                        'window_s', 'rows_per_s', 'reader_wait_fraction', 'bottleneck')}
                        for t in ticks]}
    out['autotune_replay'] = {'rc': replay.returncode, 'result': proposal}
    emit(out)
    if (watch.returncode != 0 or len(ticks) != WATCH_TICKS or proposal is None
            or proposal['windows'] != WATCH_TICKS - 1 or 'workers_count' not in
            proposal['proposal']):
        raise AssertionError('diagnose_checks: watch/replay: {} {} {}'.format(
            out, watch.stderr[-2000:], replay.stderr[-2000:]))
    shutil.rmtree(pod_dir, ignore_errors=True)


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


def run_seq_path(torch, name, url, features, mesh, new_state, graphed, model_line, steps=STEPS,
                 tag=None):
    """One sequence path: a fresh model from the seed (``new_state()``), the
    example's reader (``make_reader(output='columnar', ngram=...,
    shuffle_row_groups=True, seed=0, num_epochs=None)``, default pool), a
    loader of batch 16 staged onto the mesh's data sharding,
    ``stack_ngram_time_axis`` on the card, 3 warm-up and ``steps`` measured
    steps through ``pipeline_duty_cycle``; ``model_line`` describes the
    model on the path's line, ``tag`` marks a repeated run. Returns the state, the step, the first
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
        url, step_fn, seq_args, batch_size=SEQ_BATCH, steps=steps, warmup_steps=WARMUP_STEPS,
        reader_kwargs={'ngram': seq_ngram(SEQ_WINDOW), 'output': 'columnar',
                       'shuffle_row_groups': True, 'seed': SEQ_SEED},
        loader_kwargs={'seed': SEQ_SEED}, telemetry='counters', to_device=data_sharding(mesh))
    wall_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    auxes = [float(x) for x in auxes]
    stall = result.extra['stall']
    line = {'phase': 'path', 'path': name, 'step': 'graphed' if graphed else 'eager', 'tag': tag}
    line.update(model_line)
    line.update({
        'dtype': 'float32', 'd_model': 64, 'num_heads': 4, 'num_layers': 2, 'window': SEQ_WINDOW,
        'feature_dim': SEQ_FEATURES, 'num_classes': SEQ_CLASSES, 'batch_size': SEQ_BATCH,
        'rows': SEQ_ROWS, 'mesh': list(mesh.shape), 'warmup_steps': WARMUP_STEPS, 'steps': steps,
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
    if len(losses) != WARMUP_STEPS + steps or not all(math.isfinite(x) for x in losses + auxes):
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
    from petastorm_tpu_torch.workers import ProcessPoolOptions

    with make_reader(url, output='columnar', reader_pool_type='dummy', shuffle_row_groups=False,
                     num_epochs=1) as reader:
        blocks = [dict(b._asdict()) for b in reader]
    ngram = seq_ngram(SEQ_WINDOW)
    t0 = time.perf_counter()
    assembled = sum(len(ngram.form_ngram_columnar(block)[0]['timestamp']) for block in blocks)
    one_core_s = time.perf_counter() - t0
    workers = max(1, os.cpu_count() or 1)
    thread, thread_s = _all_windows(url, reader_pool_type='thread', workers_count=workers)
    process, process_s = _all_windows(
        url, reader_pool_type=ProcessPoolOptions(ring_bytes=ring, transport='shm'),
        workers_count=workers)
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


# -- the last device ops, MnistCNN and the example twins ---------------------

#: BASELINE.json config 1 (examples/mnist, single-process make_reader) at
#: MNIST's published split, on the generator's synthetic digits (real IDX
#: files are not in the repository); the example's batch, rate and seed
MNIST_TRAIN_ROWS = 60000
MNIST_TEST_ROWS = 10000
MNIST_BATCH = 32
MNIST_LR = 0.05
MNIST_SEED = 0
#: measured steps of each step kind's pipeline_duty_cycle run
MNIST_DUTY_STEPS = 200
#: chance is 0.1
MNIST_MIN_ACCURACY = 0.5
#: graphed MNIST losses against the eager step's on the same batches: the
#: replay runs the eager step's float32 kernels
MNIST_GRAPH_TOL = 1e-5
#: the resume check: a checkpoint every K steps, to step 2K; the resumed
#: losses against the uninterrupted ones
MNIST_RESUME_EVERY = 50
MNIST_RESUME_TOL = 1e-5
AUGMENT_CROP = 128
AUGMENT_MIXUP_ALPHA = 0.2
AUGMENT_CUTMIX_ALPHA = 1.0
AUGMENT_LABEL_TOL = 1e-6


def quietly(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with its prints captured (the examples print
    progress; this script's output is JSON lines). Returns the result and
    the number of lines printed."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, len(out.getvalue().splitlines())


def build_mnist_store(work_dir):
    """The MNIST store at the published split, written by the example
    twin's generator; a ``store`` line."""
    from petastorm_tpu_torch.examples.mnist.generate_petastorm_mnist import \
        mnist_data_to_petastorm_dataset

    path = os.path.join(work_dir, 'mnist')
    t0 = time.perf_counter()
    mnist_data_to_petastorm_dataset('file://' + path, train_rows=MNIST_TRAIN_ROWS,
                                    test_rows=MNIST_TEST_ROWS)
    emit({'phase': 'store', 'store': 'mnist', 'rows': MNIST_TRAIN_ROWS + MNIST_TEST_ROWS,
          'bytes': _dir_bytes(path), 'build_s': time.perf_counter() - t0})
    return 'file://' + path


def phase_mnist(torch, url):
    """``mnist``: ``torch_example.train_and_test`` (batch 32, lr 0.05, seed
    0, one epoch) with the eager and with the graphed step, each line with
    the final loss, the test accuracy (> 0.5) and the example's seconds, and
    beside them examples/s, median step ms and stall of
    ``pipeline_duty_cycle`` over the example's reader and loader arguments
    with the same step (3 + 200 steps); then a ``graph_check``: a fresh
    eager step on the graphed duty run's first four batches."""
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.examples.mnist import torch_example
    from petastorm_tpu_torch.models.train import make_train_step
    from petastorm_tpu_torch.tools.throughput import pipeline_duty_cycle

    graphed_run = None
    for graphed in (False, True):
        kind = 'graphed' if graphed else 'eager'
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, losses, accuracy), printed = quietly(
            torch_example.train_and_test, url, batch_size=MNIST_BATCH, epochs=1, lr=MNIST_LR,
            seed=MNIST_SEED, graphed=graphed)
        torch.cuda.synchronize()
        example_wall_s = time.perf_counter() - t0
        duty_state = torch_example.new_mnist_state(MNIST_SEED, MNIST_LR)
        step = make_train_step(graphed=graphed)
        duty_losses, batches = [], []

        def step_fn(images, labels):
            if len(batches) < SAME_BATCHES:
                batches.append((images, labels))
            duty_losses.append(step(duty_state, images, labels)[1]['loss'])

        obs.get_registry().reset()
        obs.get_ring().clear()
        result = pipeline_duty_cycle(
            url + '/train', step_fn, lambda b: (b['image'], b['digit']), batch_size=MNIST_BATCH,
            steps=MNIST_DUTY_STEPS, warmup_steps=WARMUP_STEPS,
            reader_kwargs={'output': 'rows', 'seed': MNIST_SEED,
                           'transform_spec': torch_example.TRANSFORM},
            loader_kwargs={'shuffling_queue_capacity': 256, 'seed': MNIST_SEED},
            telemetry='counters')
        duty_losses = [float(x) for x in duty_losses]
        stall = result.extra['stall']
        emit({'phase': 'mnist', 'step': kind, 'model': 'MnistCNN', 'dtype': 'float32',
              'batch_size': MNIST_BATCH, 'lr': MNIST_LR, 'train_rows': MNIST_TRAIN_ROWS,
              'test_rows': MNIST_TEST_ROWS, 'example_steps': len(losses),
              'example_s': example_wall_s, 'example_lines_printed': printed,
              'final_loss': losses[-1], 'test_accuracy': accuracy,
              'examples_per_sec': result.samples_per_second,
              'input_stall_fraction': result.input_stall_fraction,
              'median_step_ms': result.extra['median_step_ms'],
              'duty_steps': [WARMUP_STEPS, MNIST_DUTY_STEPS], 'stall': stall,
              'stage_s': {k[len('stage_'):-2]: v
                          for k, v in sorted(result.extra['diagnostics'].items())
                          if k.startswith('stage_') and k.endswith('_s')}})
        if len(losses) != MNIST_TRAIN_ROWS // MNIST_BATCH or not all(
                math.isfinite(x) for x in losses + duty_losses):
            raise AssertionError('mnist {}: {} losses, not all finite'.format(kind, len(losses)))
        if not accuracy > MNIST_MIN_ACCURACY:
            raise AssertionError('mnist {}: test accuracy {} (chance 0.1)'.format(kind, accuracy))
        check_stall('mnist', stall)
        if graphed:
            graphed_run = (batches, duty_losses)
    batches, graphed_losses = graphed_run
    state, step = torch_example.new_mnist_state(MNIST_SEED, MNIST_LR), make_train_step()
    eager = [float(step(state, images, labels)[1]['loss']) for images, labels in batches]
    diffs = [abs(a - b) for a, b in zip(eager, graphed_losses)]
    emit({'phase': 'graph_check', 'path': 'mnist', 'eager_losses': eager,
          'graphed_losses': graphed_losses[:len(eager)], 'abs_diff': diffs,
          'bit_equal': eager == graphed_losses[:len(eager)], 'tolerance': MNIST_GRAPH_TOL})
    if max(diffs) > MNIST_GRAPH_TOL:
        raise AssertionError('mnist: the graphed step\'s losses {} are not the eager step\'s {} '
                             'on the same batches'.format(graphed_losses[:len(eager)], eager))


def phase_mnist_resume(torch, url, work_dir):
    """``mnist_resume``: ``resume_example.train_with_checkpointing`` on the
    dummy pool (graphed step) to step 2K with a checkpoint every K; the last
    checkpoint deleted, the same call again resumes from step K. Its batches
    must be the uninterrupted run's row for row (images and digits), its
    losses within 1e-5; the line says whether they and the parameters are
    equal to the last bit."""
    from petastorm_tpu_torch.examples.mnist import resume_example

    k = MNIST_RESUME_EVERY
    checkpoints = os.path.join(work_dir, 'mnist_ckpt')
    runs = {}

    def record(run):
        def on_step(step, batch, metrics):
            runs.setdefault(run, {})[step] = (batch['image'], batch['digit'], metrics['loss'])
        return on_step

    kwargs = dict(total_steps=2 * k, checkpoint_every=k, batch_size=MNIST_BATCH, lr=MNIST_LR,
                  seed=MNIST_SEED, reader_pool_type='dummy')
    seconds = {}
    for run in ('whole', 'resumed'):
        t0 = time.perf_counter()
        state, _ = quietly(resume_example.train_with_checkpointing, url, checkpoints,
                           on_step=record(run), **kwargs)
        torch.cuda.synchronize()
        seconds[run] = time.perf_counter() - t0
        if run == 'whole':
            whole, saved = state, sorted(os.listdir(checkpoints))
            shutil.rmtree(os.path.join(checkpoints, 'step_{:08d}'.format(2 * k)))
    steps = sorted(runs['resumed'])
    rows_equal = steps == list(range(k + 1, 2 * k + 1)) and all(
        torch.equal(runs['resumed'][s][0], runs['whole'][s][0])
        and torch.equal(runs['resumed'][s][1], runs['whole'][s][1]) for s in steps)
    losses = {run: [float(runs[run][s][2]) for s in steps] for run in runs}
    loss_diff = max(abs(a - b) for a, b in zip(losses['whole'], losses['resumed']))
    params = whole.module.state_dict()
    param_diff = max(float((t - params[name]).abs().max())
                     for name, t in state.module.state_dict().items())
    emit({'phase': 'mnist_resume', 'checkpoints': saved, 'resumed_steps': [steps[0], steps[-1]],
          'rows_equal': rows_equal, 'max_loss_diff': loss_diff,
          'losses_bit_equal': losses['whole'] == losses['resumed'],
          'max_param_diff': param_diff, 'seconds': seconds, 'tolerance': MNIST_RESUME_TOL})
    if saved != ['step_{:08d}'.format(k), 'step_{:08d}'.format(2 * k)]:
        raise AssertionError('mnist_resume: checkpoints {}'.format(saved))
    if not rows_equal:
        raise AssertionError('mnist_resume: the resumed steps {} did not train on the '
                             'uninterrupted run\'s rows'.format(steps))
    if not loss_diff <= MNIST_RESUME_TOL:
        raise AssertionError('mnist_resume: resumed losses {} against {}'.format(
            losses['resumed'], losses['whole']))


def phase_imagenet_example(torch, png_url):
    """``imagenet_example``: ``torch_resnet_example.train`` on the PNG store
    for 3 + 10 steps, graphed (ResNet-50 bf16, 1000 classes, batch 64, 160
    px, a ``('data',)`` mesh of a world of one over NCCL): finite losses,
    the first near log(1000), the normalize and batch-norm kernels launched
    every step. Returns the launches."""
    from petastorm_tpu_torch.examples.imagenet import torch_resnet_example

    steps = WARMUP_STEPS + STEPS
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    (state, losses), printed = quietly(
        torch_resnet_example.train, png_url, batch_size=BATCH, steps=steps,
        image_size=IMAGE_SIZE, num_classes=NUM_CLASSES, seed=SEED)
    torch.cuda.synchronize()
    launches = kernel_launches()
    emit({'phase': 'imagenet_example', 'step': 'graphed', 'steps': steps, 'losses': losses,
          'launches': launches, 'wall_s': time.perf_counter() - t0, 'lines_printed': printed})
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError('imagenet_example: losses {}'.format(losses))
    if abs(losses[0] - math.log(NUM_CLASSES)) > 1.0:
        raise AssertionError('imagenet_example: first loss {}'.format(losses[0]))
    check_launches('imagenet_example', launches, steps)
    return launches


def _seq_example_run(torch, url, steps):
    """One run of ``torch_sequence_example.train`` (graphed) for 3 +
    ``steps`` steps, measured as ``pipeline_duty_cycle`` measures a path:
    examples/s and the stall (the loop's wait for its batch over the wall
    time) of the measured steps, and the device clock between consecutive
    steps' ends (the wait included)."""
    from petastorm_tpu_torch.examples.sequence import torch_sequence_example

    total = WARMUP_STEPS + steps
    ends, waits, times = [], [], []

    def on_step(i, metrics, wait_s):
        if i in (WARMUP_STEPS - 1, total - 1):
            torch.cuda.synchronize()
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        ends.append(end)
        waits.append(wait_s)
        times.append(time.perf_counter())

    (_, losses), printed = quietly(
        torch_sequence_example.train, url, steps=total, batch_size=SEQ_BATCH, window=SEQ_WINDOW,
        num_classes=SEQ_CLASSES, seed=SEQ_SEED, on_step=on_step)
    torch.cuda.synchronize()
    if len(losses) != total or not all(math.isfinite(x) for x in losses):
        raise AssertionError('seq_example: losses {}'.format(losses))
    if abs(losses[0] - math.log(SEQ_CLASSES)) > 1.0:
        raise AssertionError('seq_example: first loss {}'.format(losses[0]))
    wall = times[-1] - times[WARMUP_STEPS - 1]
    iter_ms = [ends[i - 1].elapsed_time(ends[i]) for i in range(WARMUP_STEPS, total)]
    return {'examples_per_sec': steps * SEQ_BATCH / wall,
            'input_stall_fraction': sum(waits[WARMUP_STEPS:]) / wall,
            'median_iter_ms': statistics.median(iter_ms),
            'median_wait_ms': 1e3 * statistics.median(waits[WARMUP_STEPS:]),
            'first_loss': losses[0], 'last_loss': losses[-1], 'lines_printed': printed}


#: measured steps of each run of ``seq_example`` and of the ``seq_ring``
#: runs beside it: ten are too few to compare the two flows
SEQ_EXAMPLE_STEPS = 100


def phase_seq_example(torch, url, features):
    """``seq_example``: the sequence example's own flow
    (``torch_sequence_example.train``: the window stacked on the host,
    ``features`` and the labels the only tensors staged, 2 a batch,
    synchronously) against ``seq_ring``'s graphed flow (the nested batch's
    24 tensors staged on the prefetch thread, ``tag`` ``beside_seq_example``
    on its path lines), 3 + 100 graphed steps each on the ``seq`` store, in
    turns: ring, example, example, ring. One line with every run and the
    ratio of the medians of examples/s."""
    import torch.distributed as dist

    from petastorm_tpu_torch.parallel import make_mesh

    runs = {'seq_ring': [], 'seq_example': []}
    for flow in ('seq_ring', 'seq_example', 'seq_example', 'seq_ring'):
        if flow == 'seq_example':
            runs[flow].append(_seq_example_run(torch, url, SEQ_EXAMPLE_STEPS))
            continue
        mesh = make_mesh(('data', 'seq'), device=DEVICE_TYPE)
        try:
            result = run_seq_path(
                torch, 'seq_ring', url, features, mesh,
                functools.partial(new_seq_state, torch, mesh, 'ring'), True,
                {'model': 'sequence_transformer', 'context_parallelism': 'ring'},
                steps=SEQ_EXAMPLE_STEPS, tag='beside_seq_example')[3]
        finally:
            dist.destroy_process_group()
        runs[flow].append({'examples_per_sec': result.samples_per_second,
                           'input_stall_fraction': result.input_stall_fraction,
                           'median_step_ms': result.extra['median_step_ms']})
    medians = {flow: statistics.median(r['examples_per_sec'] for r in flow_runs)
               for flow, flow_runs in runs.items()}
    emit({'phase': 'seq_example', 'step': 'graphed', 'window': SEQ_WINDOW,
          'batch_size': SEQ_BATCH, 'steps': [WARMUP_STEPS, SEQ_EXAMPLE_STEPS],
          'staged_tensors_per_batch': {'seq_example': 2, 'seq_ring': 3 * SEQ_WINDOW},
          'runs': runs, 'median_examples_per_sec': medians,
          'example_vs_ring': medians['seq_example'] / medians['seq_ring']})


def phase_hello_checks(torch, work_dir):
    """``hello_checks``: both hello worlds' stores, written by the twins'
    generators; each ``torch_hello_world`` on the card, every batch equal
    to the same twin's read on the CPU; the row and reference-API twins'
    reads beside them."""
    from petastorm_tpu_torch.examples.hello_world.external_dataset import (
        generate_external_dataset, python_hello_world as ext_python,
        pytorch_hello_world as ext_pytorch, torch_hello_world as ext_torch)
    from petastorm_tpu_torch.examples.hello_world.petastorm_dataset import (
        generate_petastorm_dataset, python_hello_world as hw_python,
        pytorch_hello_world as hw_pytorch, torch_hello_world as hw_torch)

    urls = {name: 'file://' + os.path.join(work_dir, name)
            for name in ('hello_world', 'external')}
    quietly(generate_petastorm_dataset.generate_petastorm_dataset, urls['hello_world'])
    quietly(generate_external_dataset.generate_external_dataset, urls['external'])
    line = {'phase': 'hello_checks'}
    for name, module, python, pytorch in (
            ('hello_world', hw_torch, hw_python, hw_pytorch),
            ('external', ext_torch, ext_python, ext_pytorch)):
        card, _ = quietly(module.torch_hello_world, urls[name])
        cpu, _ = quietly(module.torch_hello_world, urls[name], device='cpu')
        equal = len(card) == len(cpu) > 0 and all(
            sorted(a) == sorted(b) and all(a[k].device.type == DEVICE_TYPE
                                           and torch.equal(a[k].cpu(), b[k]) for k in a)
            for a, b in zip(card, cpu))
        rows, _ = quietly(python.python_hello_world, urls[name])
        sample, _ = quietly(pytorch.pytorch_hello_world, urls[name])
        line[name] = {'batches': len(card), 'rows': sum(len(b['id']) for b in card),
                      'fields': sorted(card[0]), 'device': str(card[0]['id'].device),
                      'equal_to_cpu': equal, 'python_items': len(rows),
                      'pytorch_sample_ids': sample['id'].tolist()}
        if not equal:
            raise AssertionError('hello_checks: {} batches on the card differ from the CPU '
                                 'read'.format(name))
    emit(line)


def phase_augment_checks(torch):
    """``augment_checks``: ``random_crop`` to 128x128, ``mixup`` (alpha
    0.2) and ``cutmix`` (alpha 1.0) on a 64x160x160x3 uint8 batch with 1000
    classes: draws from a generator on the card, each apply on the card and
    on the CPU from the same draws (images exact, mixup within 1 where the
    float32 blend lands on .5; soft labels within 1e-6), then each apply's
    CUDA-event time over 16 rotating batches beside the time its bytes take
    at the HBM rate. Plain torch ops, as plain ``jnp`` in JAX."""
    from petastorm_tpu_torch.ops import augment, cutmix, mixup, random_crop

    dev = torch.device(DEVICE_TYPE)
    gen = np.random.default_rng(SEED)
    shape = (BATCH, IMAGE_SIZE, IMAGE_SIZE, 3)
    inputs = [torch.from_numpy(gen.integers(0, 256, shape, dtype=np.uint8)).to(dev)
              for _ in range(16)]
    labels = torch.from_numpy(gen.integers(0, NUM_CLASSES, BATCH)).to(dev)
    images = inputs[0]
    generator = torch.Generator(device=dev)
    generator.manual_seed(SEED)
    ys, xs = augment.crop_offsets(BATCH, IMAGE_SIZE, IMAGE_SIZE, AUGMENT_CROP, AUGMENT_CROP,
                                  generator)
    mix = augment.mixup_draw(BATCH, generator, AUGMENT_MIXUP_ALPHA)
    cut = augment.cutmix_draw(BATCH, IMAGE_SIZE, IMAGE_SIZE, generator, AUGMENT_CUTMIX_ALPHA)

    applies = {
        'random_crop': lambda x, y, d: (augment.crop_with_offsets(x, *d, AUGMENT_CROP,
                                                                  AUGMENT_CROP), None),
        'mixup': lambda x, y, d: augment.mixup_with(x, y, *d, num_classes=NUM_CLASSES),
        'cutmix': lambda x, y, d: augment.cutmix_with(x, y, *d, num_classes=NUM_CLASSES)}
    draws = {'random_crop': (ys, xs), 'mixup': mix, 'cutmix': cut}
    image_bytes = images.numel()
    crop_bytes = BATCH * AUGMENT_CROP * AUGMENT_CROP * 3
    soft_bytes = BATCH * NUM_CLASSES * 4
    bytes_moved = {'random_crop': (crop_bytes + 2 * BATCH * 8, crop_bytes),
                   'mixup': (image_bytes + 2 * BATCH * 8 + 4, image_bytes + soft_bytes),
                   'cutmix': (image_bytes + 2 * BATCH * 8 + 4 + 16, image_bytes + soft_bytes)}
    line = {'phase': 'augment_checks', 'shape': list(shape), 'num_classes': NUM_CLASSES,
            'crop': AUGMENT_CROP, 'alpha': {'mixup': AUGMENT_MIXUP_ALPHA,
                                            'cutmix': AUGMENT_CUTMIX_ALPHA},
            'lam': {'mixup': float(mix[1]), 'cutmix': float(cut[1])}, 'ops': {}}
    cpu_images, cpu_labels = images.cpu(), labels.cpu()
    for name, apply in applies.items():
        card_images, card_labels = apply(images, labels, draws[name])
        host_images, host_labels = apply(cpu_images, cpu_labels,
                                         tuple(d.cpu() for d in draws[name]))
        torch.cuda.synchronize()
        diff = (card_images.cpu().int() - host_images.int()).abs()
        image_err = int(diff.max())
        label_err = (0.0 if card_labels is None
                     else float((card_labels.cpu() - host_labels).abs().max()))
        allowed = 1 if name == 'mixup' else 0
        read, written = bytes_moved[name]
        ms = cuda_ms(torch, lambda x, apply=apply, d=draws[name]: apply(x, labels, d), inputs)
        line['ops'][name] = {
            'shape_out': list(card_images.shape), 'max_abs_err_images': image_err,
            'differing_elements': int((diff > 0).sum()), 'images_tolerance': allowed,
            'max_abs_err_labels': label_err, 'labels_tolerance': AUGMENT_LABEL_TOL,
            'ms': ms, 'bound_ms': (read + written) / HBM_BYTES_PER_S * 1e3, 'bound_by': 'bytes',
            'bytes_read': read, 'bytes_written': written}
        if image_err > allowed or not label_err <= AUGMENT_LABEL_TOL:
            emit(line)
            raise AssertionError('augment_checks: {} on the card differs from the CPU: images '
                                 '{}, labels {}'.format(name, image_err, label_err))
    # the whole ops (draw and apply) once on the card, at the path's shapes
    whole = {'random_crop': random_crop(images, generator, AUGMENT_CROP, AUGMENT_CROP).shape,
             'mixup': mixup(images, labels, generator, AUGMENT_MIXUP_ALPHA, NUM_CLASSES)[1].shape,
             'cutmix': cutmix(images, labels, generator, AUGMENT_CUTMIX_ALPHA,
                              NUM_CLASSES)[1].shape}
    line['whole_op_shapes'] = {k: list(v) for k, v in whole.items()}
    emit(line)
    del inputs



# -- remote stores: mock-remote:// through the chunk cache -----------------------------

#: storage faults injected into each cold epoch. They are consecutive in one
#: process, so the first storage operation of the run meets them all: the
#: policy allows one attempt more than the faults, with short sleeps
REMOTE_FAULTS = 8
REMOTE_RETRY = {'max_attempts': REMOTE_FAULTS + 1, 'initial_backoff_s': 0.005,
                'max_backoff_s': 0.05}
#: the footer's first tail read (``chunkstore/reader.py``): a footer larger
#: than this less its trailer costs one more mirror
REMOTE_FOOTER_GUESS = 64 * 1024
#: the prefetcher check's in-flight budget: two and a half of the raw
#: store's 4.9 MB image chunks
PREFETCH_CHECK_BUDGET = 12 << 20


def remote_url(url):
    """The ``mock-remote://`` URL of a local ``file://`` store: the same
    files behind the retry wrapper the object stores get."""
    return 'mock-remote://' + url[len('file://'):]


def remote_policy():
    from petastorm_tpu_torch.retry import RetryPolicy

    return RetryPolicy(**REMOTE_RETRY)


def mirrored_chunks(url, fused):
    """How many mirrors a full read of the store at ``url`` makes,
    computed from its Parquet footers: each file's footer tail (two when it
    outgrows the first read) and every column chunk the page scan
    qualifies (``pagescan.column_qualifies``), or with ``fused`` every column
    chunk (the fused read decodes dictionary, snappy and PNG chunks from
    their mirrors)."""
    import pyarrow.parquet as pq

    from petastorm_tpu_torch.native import pagescan

    path = url[len('file://'):]
    count = 0
    for name in sorted(os.listdir(path)):
        if not name.endswith('.parquet'):
            continue
        full = os.path.join(path, name)
        with open(full, 'rb') as f:
            f.seek(-8, os.SEEK_END)
            footer_len = int.from_bytes(f.read(4), 'little')
        count += 1 if footer_len + 8 + 64 <= min(REMOTE_FOOTER_GUESS,
                                                 os.path.getsize(full)) else 2
        meta = pq.ParquetFile(full).metadata
        for rg in range(meta.num_row_groups):
            for c in range(meta.num_columns):
                schema_col = meta.schema.column(c)
                count += bool(fused or pagescan.column_qualifies(
                    meta.row_group(rg).column(c), schema_col.max_definition_level,
                    schema_col.max_repetition_level))
    return count


def mirror_files(root):
    """The mirrors under a chunk-cache root: relative path -> size."""
    out = {}
    for dirpath, dirnames, names in os.walk(root):
        if os.path.basename(dirpath) == 'stats':
            dirnames[:] = []
            continue
        for name in names:
            if name.endswith('.chunk'):
                full = os.path.join(dirpath, name)
                out[os.path.relpath(full, root)] = os.path.getsize(full)
    return out


def chunk_counters(root, **config):
    """The ``chunk_cache_*`` counters of ``root``, merged over every process
    that wrote its stats there."""
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig, cache_diagnostics

    return cache_diagnostics(ChunkCacheConfig(root, **config))


def _block_keys(block):
    """Row keys of a columnar block (its label and its image's crc32)."""
    return _row_keys(block.image, block.label)


def remote_cold_epoch(name, url, root, fused):
    """One epoch of the mock-remote store at ``url`` through the thread pool
    into an empty chunk cache at ``root``, with :data:`REMOTE_FAULTS` storage
    faults injected (``faults.FaultPlan(storage_fail_first=...)``): exactly
    the store's rows, every fault retried, and every chunk that qualifies
    fetched once (a demand miss, or ahead by the prefetcher) into one
    mirror. The rate measures mirroring from local files, not a network."""
    from petastorm_tpu_torch import faults, make_reader
    from petastorm_tpu_torch import observability as obs

    expected = mirrored_chunks(url, fused)
    keys = collections.Counter()
    obs.get_registry().reset()
    faults.install(faults.FaultPlan(storage_fail_first=REMOTE_FAULTS))
    try:
        t0 = time.perf_counter()
        with make_reader(remote_url(url), output='columnar', seed=SEED, num_epochs=1,
                         workers_count=max(1, os.cpu_count() or 1), chunk_cache=root,
                         storage_retry_policy=remote_policy()) as reader:
            for block in reader:
                keys.update(_block_keys(block))
            diag = reader.diagnostics
        seconds = time.perf_counter() - t0
        fired = faults.storage_faults_fired()
    finally:
        faults.uninstall()
    counters = chunk_counters(root)
    mirrors = mirror_files(root)
    fetched = counters['chunk_cache_misses'] + counters['chunk_cache_prefetch_chunks']
    line = {'phase': 'remote_cold', 'path': name, 'rows': sum(keys.values()),
            'seconds': seconds, 'rows_per_s': sum(keys.values()) / seconds,
            'faults_injected': REMOTE_FAULTS, 'faults_retried': fired,
            'retry_policy': REMOTE_RETRY, 'qualifying_chunks': expected,
            'chunks_fetched': fetched, 'mirror_files': len(mirrors),
            'bytes_fetched': (counters['chunk_cache_bytes_fetched']
                              + counters['chunk_cache_prefetch_bytes']),
            'bytes_on_disk': sum(mirrors.values()),
            'counters': counters,
            # where the epoch's time went: the workers' stages summed over
            # threads (chunk_fetch: demand fetches inside the read or before
            # the fused call; chunk_prefetch: the prefetcher's thread)
            'stage_s': {k[len('stage_'):-2]: v for k, v in sorted(diag.items())
                        if k.startswith('stage_') and k.endswith('_s')},
            'note': 'mock-remote: local files behind the retry wrapper, so the cold epoch '
                    'measures mirroring, not a network'}
    emit(line)
    if keys != store_row_keys():
        raise AssertionError('{}: the cold epoch delivered {} rows, not the store\'s {}'.format(
            name, sum(keys.values()), ROWS))
    if fired != REMOTE_FAULTS:
        raise AssertionError('{}: {} of {} storage faults fired'.format(name, fired,
                                                                       REMOTE_FAULTS))
    if not fetched == len(mirrors) == expected:
        raise AssertionError('{}: {} chunks fetched into {} mirrors; {} qualify'.format(
            name, fetched, len(mirrors), expected))
    return line


def _chunk_deltas(before, after):
    return {k[len('chunk_cache_'):]: after[k] - before[k]
            for k in ('chunk_cache_hits', 'chunk_cache_misses', 'chunk_cache_bytes_fetched',
                      'chunk_cache_prefetch_chunks', 'chunk_cache_prefetch_bytes')}


def phase_remote_path(torch, name, url, local_runs, work_dir):
    """``raw_remote`` / ``png_fixed_remote``: the cold epoch
    (:func:`remote_cold_epoch`), then the local path's two runs from the
    mock-remote store with ``chunk_cache`` and ``storage_retry_policy``:
    no miss and no byte fetched during either run (every chunk is served
    from its mirror), and the stage timers show which route served. The raw
    store is read by the page scan over the mirrors: the hits cover every
    column the local ``raw`` path (``local_runs``, this call) serves through
    the page scan, and no ``arrow_decode`` stage runs. The fixed-shape PNG
    store is decoded by the fused call from the mirrors: one ``fused_decode``
    stage per row group read, two columns each. A ``remote_vs_local`` line
    gives both paths' numbers per step kind. Returns the launches, and the
    ``remote_cold`` line and the two runs (``raw_fabric`` stands beside
    them)."""
    local_name = name[:-len('_remote')]
    fused = local_name == 'png_fixed'
    root = os.path.join(work_dir, 'chunk_cache_' + local_name)
    cold = remote_cold_epoch(name, url, root, fused)
    before = chunk_counters(root)
    total, runs = run_path_both_ways(
        torch, name, remote_url(url), check_batch,
        reader_kwargs={'chunk_cache': root, 'storage_retry_policy': remote_policy()})
    after = chunk_counters(root)
    compare = {}
    mark = before
    for kind in ('eager', 'graphed'):
        result = runs[kind][3]
        diag = result.extra['diagnostics']
        counters = {k: v for k, v in diag.items() if k.startswith('chunk_cache_')}
        deltas = _chunk_deltas(mark, counters)
        mark = counters
        stage_count = {k[len('stage_'):-len('_count')]: v for k, v in diag.items()
                       if k.startswith('stage_') and k.endswith('_count')}
        local = local_runs[kind][3]
        local_diag = local.extra['diagnostics']
        routes = result.extra['read_routes']
        if fused:
            reads = stage_count.get('fused_decode', 0)
            ok = (reads > 0 and reads == routes.get('fused_batches_total')
                  and routes.get('fused_columns_total') == 2 * reads
                  and deltas['hits'] >= 2 * reads)
        else:
            reads = stage_count.get('pagescan', 0)
            columns = (local.extra['read_routes']['pagescan_columns_total']
                       / local_diag['stage_pagescan_count'])
            ok = reads > 0 and deltas['hits'] >= columns * reads
        ok = (ok and not stage_count.get('arrow_decode') and not stage_count.get('chunk_fetch')
              and not (deltas['misses'] or deltas['bytes_fetched'] or deltas['prefetch_chunks']))
        compare[kind] = {
            'examples_per_sec': [local.samples_per_second, result.samples_per_second],
            'median_step_ms': [local.extra['median_step_ms'], result.extra['median_step_ms']],
            'input_stall_fraction': [local.input_stall_fraction, result.input_stall_fraction],
            'chunk_cache': deltas, 'reads': reads,
            'stage_count': {k: stage_count.get(k, 0) for k in
                            ('read', 'pagescan', 'arrow_decode', 'fused_decode',
                             'chunk_fetch')}}
        if not ok:
            raise AssertionError('{} ({}): not served from the mirrors: {}'.format(
                name, kind, compare[kind]))
    emit({'phase': 'remote_vs_local', 'path': name, 'local': local_name,
          'order': [local_name, name], 'runs': compare,
          'cold_rows_per_s': cold['rows_per_s'],
          'chunk_cache_run': _chunk_deltas(before, after)})
    return total, {'cold': cold, 'runs': runs}


def _prefetch_outstanding(prefetcher):
    """The prefetcher's fetched-but-unconsumed bytes, read from another
    thread (its deque may change while read: try again)."""
    for _ in range(100):
        try:
            return sum(size for _, size, _ in list(prefetcher._outstanding))
        except RuntimeError:
            continue
    return 0


def _check_remote_process(raw_url, work_dir, ring):
    """The process pool (``zero_copy=True``, shm) over the mock-remote raw
    store into an empty cache: every block equals the thread pool's,
    every row group decoded in place by the fused call from the mirrors,
    and the counters, merged from the workers' ``stats/pid-*.json``, add up
    to the epoch's chunks: each row group's two demanded once, and each
    process that opened the file its footer once."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.workers import ProcessPoolOptions
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups

    workers = max(1, os.cpu_count() or 1)
    groups = len(load_row_groups(raw_url))
    blocks = {}
    for pool in ('thread', 'process'):
        root = os.path.join(work_dir, 'chunk_cache_{}'.format(pool))
        kwargs = ({'reader_pool_type': ProcessPoolOptions(ring_bytes=ring, transport='shm',
                                                          results_timeout_s=120),
                   'zero_copy': True}
                  if pool == 'process' else {})
        with make_reader(remote_url(raw_url), output='columnar', shuffle_row_groups=False,
                         workers_count=workers, chunk_cache=root,
                         storage_retry_policy=remote_policy(), **kwargs) as reader:
            blocks[pool] = sorted(tuple(_block_keys(block)) for block in reader)
            diag = reader.diagnostics
    counters = chunk_counters(root)
    demands = counters['chunk_cache_hits'] + counters['chunk_cache_misses']
    stats = sorted(n for n in os.listdir(os.path.join(root, 'stats')) if n.endswith('.json'))
    out = {'workers': workers, 'row_groups': groups, 'blocks': len(blocks['process']),
           'demands': demands, 'mirror_files': len(mirror_files(root)),
           'stats_files': len(stats), 'counters': counters,
           'fused_inplace_batches_total': diag.get('fused_inplace_batches_total'),
           'worker_restarts': diag['worker_restarts'], 'transport': diag['transport']}
    if (blocks['process'] != blocks['thread'] or len(blocks['process']) != groups
            or not 2 * groups + 1 <= demands <= 2 * groups + workers + 1
            or out['mirror_files'] != mirrored_chunks(raw_url, False)
            or out['fused_inplace_batches_total'] != groups or len(stats) < 2
            or diag['worker_restarts'] or diag['transport'] != 'shm'):
        raise AssertionError('remote process pool: {}'.format(out))
    return out


def _check_remote_eviction(torch, raw_url, work_dir):
    """A cache bounded below the store's size (three image chunks): every
    batch the loader hands to ``prefetch_to_device`` is held on the host
    (views over mirrors) while the pinned copy is staged, so the evictor
    skips their chunks (``evict_skipped_pinned > 0``); after more pressure
    every held batch and every staged copy still equals the store's rows."""
    from petastorm_tpu_torch import make_reader
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig, open_store
    from petastorm_tpu_torch.torch import TorchDataLoader, prefetch_to_device

    image_chunk = ROWS_PER_ROW_GROUP * IMAGE_SIZE * IMAGE_SIZE * 3
    config = ChunkCacheConfig(os.path.join(work_dir, 'chunk_cache_evict'),
                              size_limit_bytes=3 * image_chunk)
    held, staged = [], []
    with make_reader(remote_url(raw_url), output='columnar', reader_pool_type='dummy',
                     shuffle_row_groups=False, chunk_cache=config,
                     storage_retry_policy=remote_policy()) as reader:
        loader = TorchDataLoader(reader, BATCH)

        def holding():
            for batch in loader:
                held.append(batch)
                yield batch

        batches = prefetch_to_device(holding(), DEVICE_TYPE, size=2)
        for batch in batches:
            staged.append((batch['image'], batch['label']))
        batches.close()
        counters = chunk_counters(config.root, size_limit_bytes=config.size_limit_bytes)
        pinned = counters['chunk_cache_chunks_pinned']
        open_store(config).ensure('pressure', image_chunk, lambda: b'\0' * image_chunk)
        after = chunk_counters(config.root, size_limit_bytes=config.size_limit_bytes)
        host_keys = collections.Counter(k for b in held for k in _row_keys(b['image'],
                                                                          b['label']))
        card_keys = collections.Counter(k for images, labels in staged
                                        for k in _row_keys(images, labels))
    out = {'size_limit_bytes': config.size_limit_bytes, 'batches': len(held),
           'chunks_pinned': pinned, 'counters': after,
           'rows_equal': host_keys == card_keys == store_row_keys()}
    del held, staged
    if not (out['rows_equal'] and after['chunk_cache_evict_skipped_pinned'] > 0
            and after['chunk_cache_chunks_evicted'] > 0 and pinned > 0):
        raise AssertionError('remote eviction under live batches: {}'.format(out))
    return out


def _check_remote_prefetcher(raw_url, work_dir):
    """The chunk prefetcher over the raw store's first row groups with no
    consumer: it fetches ahead before any demand (``prefetch_chunks > 0``)
    and stops at its in-flight budget; a demand read of the first row group
    consumes what it fetched and lets it go on. The in-flight bytes, sampled
    every millisecond, never exceed the budget."""
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig
    from petastorm_tpu_torch.chunkstore.prefetch import ChunkPrefetcher
    from petastorm_tpu_torch.chunkstore.reader import ChunkCachedParquetFile
    from petastorm_tpu_torch.etl.dataset_metadata import load_row_groups
    from petastorm_tpu_torch.fs import FilesystemResolver

    class Upcoming(object):
        def __init__(self, items):
            self._items = items

        def upcoming_items(self, max_items):
            return self._items[:max_items]

    pieces = load_row_groups(raw_url)[:6]
    resolver = FilesystemResolver(remote_url(raw_url), retry_policy=remote_policy())
    config = ChunkCacheConfig(os.path.join(work_dir, 'chunk_cache_prefetch'),
                              prefetch_budget_bytes=PREFETCH_CHECK_BUDGET)
    prefetcher = ChunkPrefetcher(Upcoming([{'piece_index': i} for i in range(len(pieces))]),
                                 pieces, ['image', 'label'], resolver.filesystem_factory(),
                                 config)
    peak = [0]
    sampling = threading.Event()

    def sample():
        while not sampling.is_set():
            peak[0] = max(peak[0], _prefetch_outstanding(prefetcher))
            time.sleep(0.001)

    sampler = threading.Thread(target=sample, name='smoke-prefetch-sampler')
    sampler.start()
    prefetcher.start()
    try:
        deadline = time.monotonic() + 60
        last, since = -1, time.monotonic()
        while time.monotonic() < deadline:
            now = chunk_counters(config.root)['chunk_cache_prefetch_chunks']
            if now != last:
                last, since = now, time.monotonic()
            elif now and time.monotonic() - since > 0.5:
                break
            time.sleep(0.01)
        stalled = chunk_counters(config.root)
        pf = ChunkCachedParquetFile(pieces[0].path, resolver.filesystem(), config)
        try:
            pf.read_row_group(0, ['image', 'label'])
        finally:
            pf.close()
        deadline = time.monotonic() + 60
        while (chunk_counters(config.root)['chunk_cache_prefetch_chunks']
               <= stalled['chunk_cache_prefetch_chunks'] and time.monotonic() < deadline):
            time.sleep(0.01)
        resumed = chunk_counters(config.root)
    finally:
        prefetcher.stop()
        prefetcher.join()
        sampling.set()
        sampler.join()
    out = {'budget_bytes': PREFETCH_CHECK_BUDGET, 'peak_inflight_bytes': peak[0],
           'prefetch_chunks_at_stall': stalled['chunk_cache_prefetch_chunks'],
           'misses_at_stall': stalled['chunk_cache_misses'],
           'prefetch_chunks_after_demand': resumed['chunk_cache_prefetch_chunks'],
           'hits_of_demand': resumed['chunk_cache_hits'] - stalled['chunk_cache_hits']}
    # the only demand before the read is the prefetcher's own footer read
    if not (stalled['chunk_cache_prefetch_chunks'] > 0 and stalled['chunk_cache_misses'] <= 1
            and 0 < peak[0] <= PREFETCH_CHECK_BUDGET
            and out['prefetch_chunks_after_demand'] > out['prefetch_chunks_at_stall']
            and out['hits_of_demand'] >= 2):
        raise AssertionError('remote prefetcher: {}'.format(out))
    return out


def _check_remote_retries():
    """An exhausted policy raises the original error after its attempts; a
    permanent error is raised at once, not retried."""
    from petastorm_tpu_torch.retry import RetryPolicy

    policy = RetryPolicy(max_attempts=3, initial_backoff_s=0.001, max_backoff_s=0.002)
    outcomes = {}
    for kind, error in (('transient', ConnectionResetError('connection reset by peer')),
                        ('permanent', FileNotFoundError('no such object'))):
        calls = []

        def fail(error=error, calls=calls):
            calls.append(1)
            raise error
        try:
            policy.call(fail)
            raised = None
        except Exception as e:  # noqa: BLE001 - the check names what came out
            raised = e
        outcomes[kind] = {'attempts': len(calls), 'original': raised is error}
    if outcomes != {'transient': {'attempts': 3, 'original': True},
                    'permanent': {'attempts': 1, 'original': True}}:
        raise AssertionError('retry policy: {}'.format(outcomes))
    return outcomes


def _check_remote_served(fixed_url, work_dir, ring):
    """The fixed-shape PNG store (mock-remote) through the serve daemon with
    ``chunk_cache``: the tenant's blocks equal a private reader's, and the
    daemon's stats show the stream's cache, every qualifying chunk fetched
    once into it."""
    from petastorm_tpu_torch import make_reader

    svc_dir = os.path.join(work_dir, 'svc_remote')
    root = os.path.join(work_dir, 'chunk_cache_served')
    workers = max(1, os.cpu_count() or 1)
    kwargs = {'output': 'columnar', 'seed': SEED, 'num_epochs': 1, 'chunk_cache': root,
              'storage_retry_policy': remote_policy()}
    proc = start_daemon(svc_dir, ring, workers)
    try:
        with make_reader(remote_url(fixed_url), serve=svc_dir, **kwargs) as served:
            tenant = sorted(tuple(_block_keys(block)) for block in served)
            stats = service_stats(svc_dir)
    finally:
        shutdown_s = stop_daemon(proc, svc_dir)
    private_root = os.path.join(work_dir, 'chunk_cache_private')
    with make_reader(remote_url(fixed_url), workers_count=workers,
                     **dict(kwargs, chunk_cache=private_root)) as private:
        mine = sorted(tuple(_block_keys(block)) for block in private)
    cache = [s['chunk_cache'] for s in stats['streams'].values()]
    expected = mirrored_chunks(fixed_url, True)
    out = {'blocks': len(tenant), 'stream_chunk_cache': cache, 'qualifying_chunks': expected,
           'mirror_files': len(mirror_files(root)), 'daemon_shutdown_s': shutdown_s}
    fetched = [c['chunk_cache_misses'] + c['chunk_cache_prefetch_chunks'] for c in cache
               if c is not None]
    if tenant != mine or not tenant or fetched != [expected] \
            or out['mirror_files'] != expected:
        raise AssertionError('remote serve: {}'.format(out))
    return out


def phase_remote_checks(torch, raw_url, fixed_url, work_dir, ring, serve_ring):
    """``remote_checks``: the host side of the remote stores (the process
    pool, eviction under live batches with the staging, the prefetcher's
    budget, the retry policy's outcomes, the serve daemon), each with its
    seconds. No failure is caught."""
    seconds, checks = {}, {}
    for name, fn, args in (('process_pool', _check_remote_process, (raw_url, work_dir, ring)),
                           ('eviction', _check_remote_eviction, (torch, raw_url, work_dir)),
                           ('prefetcher', _check_remote_prefetcher, (raw_url, work_dir)),
                           ('retries', _check_remote_retries, ()),
                           ('serve', _check_remote_served, (fixed_url, work_dir, serve_ring))):
        t0 = time.perf_counter()
        checks[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
    emit({'phase': 'remote_checks', 'checks': checks, 'seconds': seconds,
          'total_s': sum(seconds.values())})


# -- the chunk fabric: a pod peer's mirror in front of the object store ----------------

#: the pod's lease for the peer processes and the trainer's node
FABRIC_LEASE_S = 2.0
#: the drill's fetching host: tight budgets, so the stalled peer costs little
FABRIC_DRILL = {'lease_s': FABRIC_LEASE_S, 'deadline_s': 1.5, 'io_timeout_s': 0.5,
                'connect_timeout_s': 0.5, 'failure_threshold': 3, 'breaker_reset_s': 5.0}
#: how long the drill's peer A stalls every payload: past the drill's
#: deadline, so the fetch falls back, and long enough to be SIGKILLed mid-send
FABRIC_STALL_S = 30.0
#: canonical states of ``modelcheck --fabric``'s default scope (the JAX checker's)
FABRIC_DEFAULT_STATES = 435631


def spawn_fabric_peer(url, coord, host, cache_root, out_dir, stall_s=0.0, marker=None):
    """A pod peer process (``python -m petastorm_tpu_torch.fabric._peerproc``,
    no torch): it warms its own mirror of the mock-remote store at ``url``
    into ``cache_root``, joins the pod under ``coord`` and serves, until it
    is terminated (it leaves the pod) or killed. Its ready file is
    ``<out_dir>/<host>.ready``, its log ``<out_dir>/<host>.log``."""
    cmd = [sys.executable, '-m', 'petastorm_tpu_torch.fabric._peerproc', '--url', url,
           '--coord', coord, '--host', host, '--cache-root', cache_root,
           '--lease-s', str(FABRIC_LEASE_S),
           '--ready-file', os.path.join(out_dir, host + '.ready')]
    if stall_s:
        cmd += ['--stall-s', str(stall_s), '--request-marker', marker]
    with open(os.path.join(out_dir, host + '.log'), 'w') as log:
        return subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                env=dict(os.environ, PYTHONPATH=ROOT, PSTPU_FLIGHT='0'))


def wait_fabric_peer(proc, out_dir, host, timeout_s=300):
    """Seconds until the peer is warmed, joined and serving."""
    t0 = time.perf_counter()
    ready = os.path.join(out_dir, host + '.ready')
    while not os.path.exists(ready):
        if proc.poll() is not None or time.perf_counter() - t0 > timeout_s:
            with open(os.path.join(out_dir, host + '.log')) as f:
                raise AssertionError('fabric peer {} did not start (exit {}): {}'.format(
                    host, proc.returncode, f.read()[-3000:]))
        time.sleep(0.05)
    return time.perf_counter() - t0


def stop_fabric_peer(proc):
    """SIGTERM (the peer leaves the pod), SIGKILL after 30 s; its exit code."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return proc.returncode


class ObjectStoreReads(object):
    """Counts this process's chunk reads from the object store: every call
    of ``retry.fetch_range``, through which the chunk reader fetches a
    range it mirrors (the fabric's fallback included). Installed around a
    run and removed after; counting only, the reads are the same."""

    def __init__(self):
        from petastorm_tpu_torch import retry

        self._retry = retry
        self._real = retry.fetch_range
        self._lock = threading.Lock()
        self.count = 0

    def _counted(self, *args, **kwargs):
        with self._lock:
            self.count += 1
        return self._real(*args, **kwargs)

    def __enter__(self):
        self._retry.fetch_range = self._counted
        return self

    def __exit__(self, *exc):
        self._retry.fetch_range = self._real
        return False


def fabric_stats(coord, host, pid=None):
    """A port fabric client's per-peer stats file (hits, failures,
    fallbacks, bytes, latency per peer, and the breakers)."""
    from petastorm_tpu_torch.fabric.client import stats_file_name

    with open(os.path.join(coord, 'fabric', 'stats', stats_file_name(host, pid))) as f:
        return json.load(f)


def _peer_sums(stats):
    peers = stats['peers'].values()
    return {k: sum(p.get(k, 0) for p in peers)
            for k in ('hits', 'failures', 'fallbacks', 'bytes', 'latency_sum', 'latency_n')}


def phase_raw_fabric(torch, url, work_dir, remote):
    """``raw_fabric``: the ``raw`` path's trainer as host ``h0`` of a pod whose
    other host (``h1``, a peer process) has warmed its own mirror of the
    mock-remote raw store and serves it. For each step kind the trainer
    starts a fabric node of its own over an empty chunk-cache root
    (``fabric.start_node(FabricConfig(coord, 'h0-<kind>', cache))``),
    installs it and trains through :func:`run_path_both_ways`: every chunk
    the run populates (demand misses and prefetched chunks) must be a peer
    copy from ``h1``, with no fallback, no chunk read from the object store
    by the trainer's process (:class:`ObjectStoreReads`) and no Arrow
    decode. A ``fabric_vs_remote`` line stands beside ``raw_remote``'s cold
    and warm numbers of the same call (``remote``: its ``cold`` line and its
    ``runs``): examples/s, median step ms and stall per step kind, the peer
    copies per second of run time and their bytes, and the object-store
    chunk reads across the pod over the distinct chunks (with the fabric:
    the peer's warm-up reads; without it, as ``raw_remote``'s cold epoch
    shows, each host reads every chunk). Returns the launches."""
    from petastorm_tpu_torch import fabric, make_reader
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig

    pod_dir = tempfile.mkdtemp(prefix='fabric_', dir=work_dir)
    coord = os.path.join(pod_dir, 'coord')
    peer_root = os.path.join(pod_dir, 'cache_h1')
    distinct = mirrored_chunks(url, False)
    runs_info = []
    proc = spawn_fabric_peer(remote_url(url), coord, 'h1', peer_root, pod_dir)
    node = None

    def factory(dataset_url, **kwargs):
        nonlocal node
        if node is not None:
            node.stop()
            runs_info[-1]['seconds'] = time.perf_counter() - runs_info[-1]['t0']
        kind = ('eager', 'graphed')[len(runs_info)]
        root = os.path.join(pod_dir, 'cache_h0_' + kind)
        node = fabric.start_node(fabric.FabricConfig(
            coord, 'h0-' + kind, ChunkCacheConfig(root), lease_s=FABRIC_LEASE_S))
        fabric.install(node)
        runs_info.append({'kind': kind, 'root': root, 'host': 'h0-' + kind,
                          't0': time.perf_counter(), 'reads_before': reads.count})
        return make_reader(dataset_url, output='columnar', chunk_cache=root, **kwargs)

    try:
        peer_s = wait_fabric_peer(proc, pod_dir, 'h1')
        peer_counters = chunk_counters(peer_root)
        with ObjectStoreReads() as reads:
            total, runs = run_path_both_ways(
                torch, 'raw_fabric', remote_url(url), check_batch,
                reader_kwargs={'storage_retry_policy': remote_policy()}, reader_factory=factory)
            node.stop()
            runs_info[-1]['seconds'] = time.perf_counter() - runs_info[-1]['t0']
            runs_info[-1]['reads_after'] = reads.count
            runs_info[0]['reads_after'] = runs_info[1]['reads_before']
    finally:
        fabric.uninstall()
        if node is not None:
            node.stop()
        peer_exit = stop_fabric_peer(proc)
    peer_populated = (peer_counters['chunk_cache_misses']
                      + peer_counters['chunk_cache_prefetch_chunks'])
    compare = {}
    for info in runs_info:
        kind = info['kind']
        result = runs[kind][3]
        remote_result = remote['runs'][kind][3]
        counters = chunk_counters(info['root'])
        populated = counters['chunk_cache_misses'] + counters['chunk_cache_prefetch_chunks']
        stats = fabric_stats(coord, info['host'])
        sums = _peer_sums(stats)
        trainer_reads = info['reads_after'] - info['reads_before']
        stage_count = {k[len('stage_'):-len('_count')]: v
                       for k, v in result.extra['diagnostics'].items()
                       if k.startswith('stage_') and k.endswith('_count')}
        compare[kind] = {
            'examples_per_sec': [remote_result.samples_per_second, result.samples_per_second],
            'median_step_ms': [remote_result.extra['median_step_ms'],
                               result.extra['median_step_ms']],
            'input_stall_fraction': [remote_result.input_stall_fraction,
                                     result.input_stall_fraction],
            'chunks_populated': populated, 'peer_hits': sums['hits'],
            'peer_hits_by_peer': {h: s['hits'] for h, s in stats['peers'].items()},
            'fallbacks': sums['fallbacks'], 'failures': sums['failures'],
            'bytes_copied': sums['bytes'], 'run_s': info['seconds'],
            'peer_copies_per_s': sums['hits'] / info['seconds'],
            'peer_copy_ms_mean': (1e3 * sums['latency_sum'] / sums['latency_n']
                                  if sums['latency_n'] else None),
            'trainer_object_store_reads': trainer_reads,
            'pod_object_store_reads_per_chunk': (peer_populated + trainer_reads) / distinct,
            'arrow_decode': stage_count.get('arrow_decode', 0),
            'breakers': stats['breakers']}
        line = compare[kind]
        if not (populated == line['peer_hits'] == line['peer_hits_by_peer'].get('h1', 0)
                and populated > 0 and line['fallbacks'] == 0 and trainer_reads == 0
                and line['arrow_decode'] == 0):
            raise AssertionError('raw_fabric ({}): not every chunk a peer copy: {}'.format(
                kind, line))
    cold = remote['cold']
    emit({'phase': 'fabric_vs_remote', 'path': 'raw_fabric', 'remote': 'raw_remote',
          'order': ['raw_remote', 'raw_fabric'], 'runs': compare,
          'peer': {'host': 'h1', 'ready_s': peer_s, 'chunks_populated': peer_populated,
                   'exit': peer_exit},
          'distinct_chunks': distinct,
          'raw_remote_cold': {'rows_per_s': cold['rows_per_s'], 'seconds': cold['seconds'],
                              'chunks_fetched': cold['chunks_fetched']},
          # each host without the fabric reads every chunk from the object
          # store, as raw_remote's cold epoch did: two hosts read it twice
          'pod_object_store_reads_per_chunk_without_fabric': 2 * cold['chunks_fetched'] / distinct,
          'note': 'mock-remote: the object store is local files behind the retry wrapper and '
                  'the peer is on this host (loopback), so a copy measures the fabric\'s '
                  'protocol and mirroring, not a network'})
    if peer_exit != 0 or peer_populated != distinct:
        raise AssertionError('raw_fabric: peer exit {}, {} of {} chunks mirrored'.format(
            peer_exit, peer_populated, distinct))
    return total


def _drill_epoch(url, root, **kwargs):
    """One epoch of the mock-remote store into ``root``: its row keys."""
    from petastorm_tpu_torch import make_reader

    keys = collections.Counter()
    with make_reader(remote_url(url), output='columnar', shuffle_row_groups=False, num_epochs=1,
                     workers_count=max(1, os.cpu_count() or 1), chunk_cache=root,
                     storage_retry_policy=remote_policy(), **kwargs) as reader:
        for block in reader:
            keys.update(_block_keys(block))
    return keys


def _mirror_bytes(root):
    """The mirrors under ``root``: digest -> sha256 of the bytes."""
    out = {}
    for rel in mirror_files(root):
        with open(os.path.join(root, rel), 'rb') as f:
            out[os.path.basename(rel)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _check_fabric_drill(url, pod_dir, coord):
    """The drill of ``docs/fabric.md`` on the raw store: peer A (a peer
    process) stalls every payload and is SIGKILLed once a request reached
    it; peer B (a node in this process over a warmed mirror) resets one
    payload and truncates one; host C reads an epoch through the thread
    pool with a ``FabricMonitor``. The rows are the store's, C's mirrors
    byte-equal to B's, peer hits plus fallbacks equal C's populations and
    both are above 0, and A gave no hit and at least one failure."""
    from petastorm_tpu_torch import fabric, faults
    from petastorm_tpu_torch.analysis.protocol.monitor import FabricMonitor
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig

    marker = os.path.join(pod_dir, 'pA.request')
    proc_a = spawn_fabric_peer(remote_url(url), coord, 'pA', os.path.join(pod_dir, 'cache_pA'),
                               pod_dir, stall_s=FABRIC_STALL_S, marker=marker)
    cache_b = ChunkCacheConfig(os.path.join(pod_dir, 'cache_pB'))
    root_c = os.path.join(pod_dir, 'cache_pC')
    killed = {}
    node_b = node_c = None
    drill = FabricMonitor('drill')

    def killer():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if os.path.exists(marker):
                os.kill(proc_a.pid, signal.SIGKILL)  # A is stalling inside a send
                killed['at_s'] = time.perf_counter() - t0
                return
            time.sleep(0.02)

    try:
        _drill_epoch(url, cache_b.root)
        node_b = fabric.start_node(fabric.FabricConfig(coord, 'pB', cache_b,
                                                       lease_s=FABRIC_LEASE_S))
        wait_fabric_peer(proc_a, pod_dir, 'pA')
        faults.install_net(faults.NetFaultPlan(reset_payloads=1, truncate_payloads=1))
        t0 = time.perf_counter()
        kill_thread = threading.Thread(target=killer, daemon=True)
        kill_thread.start()
        node_c = fabric.start_node(fabric.FabricConfig(
            coord, 'pC', ChunkCacheConfig(root_c), **FABRIC_DRILL), monitor=drill)
        fabric.install(node_c)
        keys = _drill_epoch(url, root_c)
        seconds = time.perf_counter() - t0
        kill_thread.join(timeout=120)
    finally:
        fabric.uninstall()
        faults.uninstall_net()
        for node in (node_c, node_b):
            if node is not None:
                node.stop()
        proc_a.kill()
        proc_a.wait(timeout=30)
    counters = chunk_counters(root_c)
    populated = counters['chunk_cache_misses'] + counters['chunk_cache_prefetch_chunks']
    stats = fabric_stats(coord, 'pC')
    sums = _peer_sums(stats)
    mirrors_c, mirrors_b = _mirror_bytes(root_c), _mirror_bytes(cache_b.root)
    out = {'rows': sum(keys.values()), 'seconds': seconds, 'killed_at_s': killed.get('at_s'),
           'a_exit': proc_a.returncode, 'chunks_populated': populated,
           'peer_hits': sums['hits'], 'fallbacks': sums['fallbacks'],
           'failures': sums['failures'],
           'by_peer': stats['peers'], 'breakers': stats['breakers'],
           'mirrors': len(mirrors_c),
           'mirrors_equal_b': all(mirrors_b.get(d) == h for d, h in mirrors_c.items()),
           'monitor': drill.snapshot}
    a = stats['peers'].get('pA', {})
    if (keys != store_row_keys() or not killed or proc_a.returncode != -signal.SIGKILL
            or not out['mirrors_equal_b'] or populated != len(mirrors_c)
            or sums['hits'] + sums['fallbacks'] != populated
            or not (sums['hits'] > 0 and sums['fallbacks'] > 0)
            or a.get('hits', 0) != 0 or a.get('failures', 0) < 1
            or drill.snapshot['populated'] != populated):
        raise AssertionError('fabric drill: {}'.format(out))
    return out


def _check_fabric_process_pool(url, pod_dir, coord):
    """The drill's epoch through the process pool (one spawned worker per
    core, copy mode) with a node of its own installed (``pD``, fetch only):
    the fetch-only config reaches the workers, whose stats files show peer
    copies from ``pB``'s mirror (A is dead); every population a peer copy,
    the rows the store's."""
    from petastorm_tpu_torch import fabric
    from petastorm_tpu_torch.chunkstore import ChunkCacheConfig
    from petastorm_tpu_torch.fabric.client import stats_file_name
    from petastorm_tpu_torch.workers import ProcessPoolOptions

    root = os.path.join(pod_dir, 'cache_pD')
    cache_b = ChunkCacheConfig(os.path.join(pod_dir, 'cache_pB'))
    t0 = time.perf_counter()
    with fabric.start_node(fabric.FabricConfig(coord, 'pB', cache_b, lease_s=FABRIC_LEASE_S)), \
            fabric.start_node(fabric.FabricConfig(coord, 'pD', ChunkCacheConfig(root),
                                                  serve=False)) as node:
        fabric.install(node)
        try:
            keys = _drill_epoch(url, root, reader_pool_type=ProcessPoolOptions(
                results_timeout_s=120))
        finally:
            fabric.uninstall()
    seconds = time.perf_counter() - t0
    stats_dir = os.path.join(coord, 'fabric', 'stats')
    own = stats_file_name('pD')
    workers = {}
    for name in sorted(os.listdir(stats_dir)):
        if name.startswith('pD-pid') and name.endswith('.torch.json') and name != own:
            with open(os.path.join(stats_dir, name)) as f:
                workers[name] = _peer_sums(json.load(f))
    consumer = _peer_sums(fabric_stats(coord, 'pD'))
    counters = chunk_counters(root)
    populated = counters['chunk_cache_misses'] + counters['chunk_cache_prefetch_chunks']
    hits = sum(w['hits'] for w in workers.values()) + consumer['hits']
    fallbacks = sum(w['fallbacks'] for w in workers.values()) + consumer['fallbacks']
    out = {'rows': sum(keys.values()), 'seconds': seconds, 'worker_stats_files': len(workers),
           'worker_peer_hits': sum(w['hits'] for w in workers.values()),
           'consumer_peer_hits': consumer['hits'], 'fallbacks': fallbacks,
           'chunks_populated': populated}
    if (keys != store_row_keys() or not out['worker_peer_hits'] or fallbacks
            or hits != populated):
        raise AssertionError('fabric process pool: {}'.format(out))
    return out


def phase_fabric_checks(raw_url, work_dir):
    """``fabric_checks``: (a) the drill (:func:`_check_fabric_drill`), (b)
    its epoch through the process pool (:func:`_check_fabric_process_pool`),
    (c) ``python -m petastorm_tpu_torch.analysis.protocol.modelcheck
    --fabric`` at its default scope (the JAX checker's state count, clean)
    and with ``--mutate no_fallback`` (exit 1), started before (a), (d)
    ``python -m petastorm_tpu_torch.observability.diagnose --fabric`` on the
    drill's pod directory: its per-peer table, and its ``--json`` rows equal
    to ``fabric_peer_table``'s. Host only; each check's seconds."""
    from petastorm_tpu_torch.observability import diagnose

    pod_dir = tempfile.mkdtemp(prefix='fabric_drill_', dir=work_dir)
    coord = os.path.join(pod_dir, 'coord')
    cmd = [sys.executable, '-m', 'petastorm_tpu_torch.analysis.protocol.modelcheck', '--fabric']
    checks = {name: (subprocess.Popen(cmd + args, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True), time.perf_counter())
              for name, args in (('default', ['--json', '--budget-s', '600']),
                                 ('no_fallback', ['--mutate', 'no_fallback']))}
    out = {'phase': 'fabric_checks', 'seconds': {}}
    t0 = time.perf_counter()
    out['drill'] = _check_fabric_drill(raw_url, pod_dir, coord)
    out['seconds']['drill'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out['process_pool'] = _check_fabric_process_pool(raw_url, pod_dir, coord)
    out['seconds']['process_pool'] = time.perf_counter() - t0
    model = {}
    for name, (proc, started) in checks.items():
        stdout, stderr = proc.communicate(timeout=900)
        model[name] = {'exit': proc.returncode, 'seconds': time.perf_counter() - started}
        if name == 'default':
            doc = json.loads(stdout) if proc.returncode == 0 else {}
            model[name].update({k: doc.get(k) for k in ('states', 'transitions',
                                                        'terminal_states', 'depth',
                                                        'exhausted', 'violation')})
            model[name]['check_s'] = doc.get('elapsed_s')
        else:
            model[name]['counterexample'] = 'fetch_termination' in stdout
    out['modelcheck'] = model
    if (model['default']['exit'] != 0 or model['default']['states'] != FABRIC_DEFAULT_STATES
            or not model['default']['exhausted'] or model['default']['violation']
            or model['no_fallback']['exit'] != 1 or not model['no_fallback']['counterexample']):
        raise AssertionError('fabric modelcheck: {}'.format(model))
    t0 = time.perf_counter()
    diag_cmd = [sys.executable, '-m', 'petastorm_tpu_torch.observability.diagnose', '--fabric',
                coord]
    text = subprocess.run(diag_cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
    as_json = subprocess.run(diag_cmd + ['--json'], cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
    out['seconds']['diagnose'] = time.perf_counter() - t0
    out['diagnose'] = {'exit': text.returncode, 'table': text.stdout.splitlines()}
    table = json.loads(as_json.stdout)['fabric_peers'] if as_json.returncode == 0 else None
    if (text.returncode != 0 or table != json.loads(json.dumps(diagnose.fabric_peer_table(coord)))
            or not text.stdout.startswith('fabric peers') or table['pA']['failures'] < 1
            or table['pB']['hits'] < 1):
        raise AssertionError('diagnose --fabric: {} {}'.format(out['diagnose'], table))
    emit(out)


# -- the sanitizer lane ---------------------------------------------------------------

SANITIZE = 'address,undefined'


def phase_sanitize_checks():
    """``sanitize_checks``: the port's reader, image decoder and ring built
    with ``PSTPU_SANITIZE=address,undefined`` (three g++ at once, into
    ``.san.so`` files beside the release libraries) and the port's corpus
    (``petastorm_tpu_torch/test_util/native_corpus.py``: the fuzz corpus,
    the corrupt-chunk regressions with the map of bools, the compressed
    frames, the page statistics, PNG cells and resizes, the ring and
    lifetime cycles) replayed through them in a subprocess with the
    runtimes preloaded: its build and replay seconds and the items
    replayed. A finding aborts the subprocess and fails the run. On a host
    whose g++ ships no sanitizer runtime, one ``skipped`` line says so."""
    from petastorm_tpu_torch.native.build import sanitizer_preload

    preload = sanitizer_preload()
    if preload is None:
        emit({'phase': 'sanitize_checks', 'skipped': True,
              'why': 'g++ on this host ships no libasan/libubsan runtime '
                     '(g++ -print-file-name)'})
        return
    env = dict(os.environ, PSTPU_SANITIZE=SANITIZE, LD_PRELOAD=preload, PYTHONPATH=ROOT,
               PSTPU_FLIGHT='0', ASAN_OPTIONS='detect_leaks=0:abort_on_error=1',
               UBSAN_OPTIONS='halt_on_error=1:print_stacktrace=1')
    code = ('import json\nfrom petastorm_tpu_torch.test_util import native_corpus\n'
            'print(json.dumps(native_corpus.replay_all()))\n')
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=900)
    seconds = time.perf_counter() - t0
    findings = [m for m in ('AddressSanitizer', 'runtime error:') if m in proc.stderr]
    if proc.returncode != 0 or findings:
        raise AssertionError('sanitized replay exited {} ({}): {}'.format(
            proc.returncode, findings, proc.stderr[-4000:]))
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    emit({'phase': 'sanitize_checks', 'sanitize': SANITIZE, 'preload': preload,
          'build_s': report['build_s'], 'replay_s': report['replay_s'],
          'items': report['items'], 'items_total': sum(report['items'].values()),
          'libraries': {k: os.path.basename(v) for k, v in report['libraries'].items()},
          'seconds': seconds})


# -- the store layer: partitioned, appended and legacy stores ---------------------

#: the png_part path reads the png_select path's synsets out of their
#: partition directories
PART_PIECES = SELECT_SYNSETS * IMAGES_PER_SYNSET // IMAGE_ROWS_PER_ROW_GROUP
#: the etl checks' day store: the fixed-shape PNG store's rows in four days
#: of 256, a file a row group, then a fifth day appended
DAY_ROWS = 256
DAYS = ROWS // DAY_ROWS
ETL_WORKERS = 4


def _stored_cells_codec(image_format):
    """A ``compressed_image`` codec that writes cells which are encoded
    images already, as they are: a copy of a store is written through the
    port's writer without encoding its images again."""
    from petastorm_tpu_torch.codecs import CompressedImageCodec

    class StoredCells(CompressedImageCodec):
        def encode(self, field, value):
            return value

    return StoredCells(image_format)


def _store_table(url, columns):
    import pyarrow.parquet as pq

    return pq.read_table(os.path.join(url[len('file://'):], 'part-00000.parquet'),
                         columns=columns)


def build_png_part_store(png_url, url):
    """The ``png`` store's rows, cells as written, Hive-partitioned by
    ``noun_id`` through the port's ``materialize_dataset(partition_by=)``:
    one ``noun_id=<synset>/`` directory a synset, ``IMAGE_ROWS_PER_ROW_GROUP``
    rows a row group."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.etl import materialize_dataset
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    schema = Unischema('ImagenetSchema', [
        UnischemaField('noun_id', np.str_, (), ScalarCodec(), False),
        UnischemaField('text', np.str_, (), ScalarCodec(), False),
        UnischemaField('image', np.uint8, (None, None, 3), _stored_cells_codec('png'), False)])
    table = _store_table(png_url, ['noun_id', 'text', 'image'])
    with materialize_dataset(url, schema, rows_per_row_group=IMAGE_ROWS_PER_ROW_GROUP,
                             partition_by=['noun_id']) as writer:
        for row in table.to_pylist():
            writer.write(row)


def png_part_check(png_images):
    """The image check of ``png_part``: each staged image within 1 LSB of
    one of its label's images as written, of the selected synsets only."""
    synsets = set(selected_synsets())
    expected = {}
    for i, img in enumerate(png_images):
        noun_id = 'n{:08d}'.format(i // IMAGES_PER_SYNSET)
        if noun_id in synsets:
            expected.setdefault(label_of(noun_id), []).append(
                plain_resize(img, IMAGE_SIZE, IMAGE_SIZE))
    return check_image_batch(expected)


def png_part_factory(readers):
    """``make_reader(output='columnar')``, appended to ``readers``: the
    ``png_part`` path's reader factory (its reader is checked after the
    run)."""
    def factory(url, **kwargs):
        from petastorm_tpu_torch import make_reader

        reader = make_reader(url, output='columnar', **kwargs)
        readers.append(reader)
        return reader
    return factory


def check_png_part_reader(reader):
    """``png_part``: the partition pruning kept the selected synsets' row
    groups only (``PART_PIECES`` of them, 512 rows an epoch) before any
    worker opened a file, and left the workers no predicate."""
    synsets = set(selected_synsets())
    pieces = reader._pieces
    nouns = {p.partition_keys.get('noun_id') for p in pieces}
    items = reader._ventilator._items
    if (len(pieces) != PART_PIECES or nouns != synsets
            or sum(p.num_rows for p in pieces) != PART_PIECES * IMAGE_ROWS_PER_ROW_GROUP
            or any('worker_predicate' in item for item in items)):
        raise AssertionError('png_part: {} pieces of {} rows of synsets {}, worker predicates '
                             '{}'.format(len(pieces), sum(p.num_rows for p in pieces),
                                         sorted(nouns), [i.get('worker_predicate')
                                                         for i in items][:3]))


def path_numbers(runs):
    """``{step kind: {examples_per_sec, median_step_ms, input_stall_fraction}}``
    of a path's two runs."""
    return {kind: {'examples_per_sec': run[3].samples_per_second,
                   'median_step_ms': run[3].extra['median_step_ms'],
                   'input_stall_fraction': run[3].input_stall_fraction}
            for kind, run in runs.items()}


def day_schema():
    """The fixed-shape PNG store's schema with an int64 ``day`` partition
    column."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    return Unischema('PngFixedDays', [
        UnischemaField('image', np.uint8, (IMAGE_SIZE, IMAGE_SIZE, 3),
                       _stored_cells_codec('png'), False),
        UnischemaField('label', np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField('day', np.int64, (), ScalarCodec(np.int64), False)])


def write_days(url, cells, first_row, append):
    """Rows ``first_row..`` of the day store from the fixed-shape PNG
    store's ``cells`` (row ``i`` takes cell ``i % ROWS``, label
    ``i % NUM_CLASSES``, day ``i // DAY_ROWS``), a file a row group;
    returns their keys ``(day, label, crc32 of the image)``."""
    from petastorm_tpu_torch.etl import materialize_dataset

    keys = []
    with materialize_dataset(url, day_schema(), rows_per_row_group=IMAGE_ROWS_PER_ROW_GROUP,
                             rows_per_file=IMAGE_ROWS_PER_ROW_GROUP, partition_by=['day'],
                             append=append) as writer:
        for i in range(first_row, first_row + len(cells)):
            day, label = i // DAY_ROWS, i % NUM_CLASSES
            writer.write({'image': cells[i - first_row], 'label': np.int64(label),
                          'day': np.int64(day)})
            keys.append((day, label, zlib.crc32(_image(i % ROWS).tobytes())))
    return keys


def _row_keys_of(block):
    """``(day or None, label, crc32 of the image)`` of each row of a block."""
    days = block['day'] if 'day' in block else [None] * len(block['label'])
    return [(None if d is None else int(d), int(label),
             zlib.crc32(np.ascontiguousarray(img).tobytes()))
            for d, label, img in zip(days, block['label'], block['image'])]


def read_keys(url, **kwargs):
    """The keys (:func:`_row_keys_of`) of every row one epoch of
    ``make_reader(url, output='columnar')`` delivers, and its diagnostics."""
    from petastorm_tpu_torch import make_reader

    kwargs = {'workers_count': ETL_WORKERS, 'shuffle_row_groups': False, **kwargs}
    with make_reader(url, output='columnar', num_epochs=1, **kwargs) as reader:
        keys = collections.Counter(k for block in reader for k in _row_keys_of(block._asdict()))
        return keys, reader.diagnostics


def _listing(pieces):
    return [(p.path, p.row_group, p.num_rows, p.partition_keys) for p in pieces]


def _check_append(day_url, meta_root, cells, ring):
    """The day store written, copied (the ``_metadata`` checks' store: 64
    files), grown by a fifth day under ``append``; its ``_common_metadata``
    lists exactly the five days' files; one epoch through the process pool
    with ``zero_copy=True`` decodes every row group in place, ``day``
    framed as a raw column, and delivers the rows of the thread pool and
    the rows written."""
    from petastorm_tpu_torch.workers import ProcessPoolOptions
    from petastorm_tpu_torch.etl.dataset_metadata import (ROW_GROUPS_PER_FILE_KEY,
                                                           read_metadata_dict)
    from petastorm_tpu_torch.test_util.stores import data_files

    out = {}
    t0 = time.perf_counter()
    written = write_days(day_url, cells[:ROWS], 0, append=False)
    out['write_s'] = time.perf_counter() - t0
    shutil.copytree(day_url[len('file://'):], meta_root)
    t0 = time.perf_counter()
    written += write_days(day_url, cells[:DAY_ROWS], ROWS, append=True)
    out['append_s'] = time.perf_counter() - t0
    root = day_url[len('file://'):]
    counts = json.loads(read_metadata_dict(day_url)[ROW_GROUPS_PER_FILE_KEY].decode('utf-8'))
    files = data_files(root)
    days = sorted({f.split('/', 1)[0] for f in files})
    out.update(files=len(files), days=days, counted_files=len(counts))
    if (sorted(counts) != files or days != ['day={}'.format(d) for d in range(DAYS + 1)]
            or len(files) != (ROWS + DAY_ROWS) // IMAGE_ROWS_PER_ROW_GROUP):
        raise AssertionError('append: _common_metadata lists {} files, the store holds {} in '
                             '{}'.format(len(counts), len(files), days))
    written = collections.Counter(written)
    t0 = time.perf_counter()
    process, diag = read_keys(day_url, reader_pool_type=ProcessPoolOptions(
        ring_bytes=ring, transport='shm', results_timeout_s=60), zero_copy=True)
    out['process_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    thread, _ = read_keys(day_url)
    out['thread_s'] = time.perf_counter() - t0
    n_groups = (ROWS + DAY_ROWS) // IMAGE_ROWS_PER_ROW_GROUP
    out.update(rows=sum(process.values()), inplace_batches=diag['fused_inplace_batches_total'],
               publish_inplace=diag.get('publish_inplace'))
    if (process != written or thread != written or sum(written.values()) != ROWS + DAY_ROWS
            or diag['fused_inplace_batches_total'] != n_groups):
        raise AssertionError('append: {} rows through the process pool, {} through the thread '
                             'pool, {} written; {}'.format(sum(process.values()),
                                                           sum(thread.values()),
                                                           sum(written.values()), out))
    return out


def _legacy_index_pickle(ref):
    """The original library's ``SingleFieldIndexer`` on ``label`` over the
    fixed-shape PNG store's row groups, pickled."""
    import pickle

    index = ref.SingleFieldIndexer('label_idx', 'label')
    for i in range(ROWS):
        index._index_data[i % NUM_CLASSES].add(i // IMAGE_ROWS_PER_ROW_GROUP)
    return pickle.dumps({'label_idx': index}, protocol=2)


def _check_legacy(fixed_url, work_dir):
    """A copy of the fixed-shape PNG store that carries only the original
    petastorm library's pickled keys reads through the fused route to the
    store's rows; a selector over its legacy index picks the row groups a
    native index picks; ``copy_dataset`` migrates it to a native store that
    reads equal."""
    import pickle

    from petastorm_tpu_torch.etl import SingleFieldIndexer, build_rowgroup_index
    from petastorm_tpu_torch.etl.dataset_metadata import UNISCHEMA_KEY, read_metadata_dict
    from petastorm_tpu_torch.etl.rowgroup_indexing import get_row_group_indexes
    from petastorm_tpu_torch.native import read_routes
    from petastorm_tpu_torch.selectors import SingleIndexSelector
    from petastorm_tpu_torch.test_util.legacy_fakes import (reference_modules,
                                                            write_legacy_metadata)
    from petastorm_tpu_torch.tools.copy_dataset import copy_dataset

    out = {}
    src = fixed_url[len('file://'):]
    legacy_root = os.path.join(work_dir, 'png_fixed_legacy')
    native_root = os.path.join(work_dir, 'png_fixed_label_idx')
    shutil.copytree(src, legacy_root)
    shutil.copytree(src, native_root)
    with reference_modules() as ref:
        schema = ref.Unischema('PngFixed', [
            ref.UnischemaField('image', np.uint8, (IMAGE_SIZE, IMAGE_SIZE, 3),
                               ref.CompressedImageCodec('png'), False),
            ref.UnischemaField('label', np.int64, (), ref.ScalarCodec(ref.sql_types.LongType()),
                               False)])
        write_legacy_metadata(legacy_root, pickle.dumps(schema, protocol=2),
                              _legacy_index_pickle(ref))
    legacy_url = 'file://' + legacy_root
    if any(not k.startswith(b'dataset-toolkit') for k in read_metadata_dict(legacy_url)):
        raise AssertionError('the legacy copy carries keys of this package')
    expected = collections.Counter((None, i % NUM_CLASSES, zlib.crc32(_image(i).tobytes()))
                                   for i in range(ROWS))
    read_routes.reset()
    t0 = time.perf_counter()
    rows, _ = read_keys(legacy_url)
    out['read_s'] = time.perf_counter() - t0
    routes = {k: v for k, v in read_routes.snapshot().items() if v}
    out['routes'] = routes
    n = ROWS // IMAGE_ROWS_PER_ROW_GROUP
    if (rows != expected or routes.get('fused_batches_total') != n
            or routes.get('fused_columns_total') != 2 * n or set(routes) - {
                'fused_batches_total', 'fused_columns_total'}):
        raise AssertionError('legacy copy: {} rows equal to the store\'s: {}; routes {}'.format(
            sum(rows.values()), rows == expected, routes))
    # its legacy index against a native one on another copy
    t0 = time.perf_counter()
    build_rowgroup_index('file://' + native_root, [SingleFieldIndexer('label_idx', 'label')])
    legacy_indexes = get_row_group_indexes(legacy_url)
    native_indexes = get_row_group_indexes('file://' + native_root)
    selected = {}
    for values in ([3], [0, 500, 999], list(range(100, 110))):
        selector = SingleIndexSelector('label_idx', values)
        picked = selector.select_row_groups(legacy_indexes)
        if picked != selector.select_row_groups(native_indexes) or not picked:
            raise AssertionError('legacy index: {} picks {}, the native index {}'.format(
                values, sorted(picked), sorted(selector.select_row_groups(native_indexes))))
        selected[str(values[:3])] = sorted(picked)
    with_selector, _ = read_keys(legacy_url, rowgroup_selector=SingleIndexSelector(
        'label_idx', [0, 500, 999]))
    picked = set(selected['[0, 500, 999]'])
    want = collections.Counter((None, i % NUM_CLASSES, zlib.crc32(_image(i).tobytes()))
                               for i in range(ROWS) if i // IMAGE_ROWS_PER_ROW_GROUP in picked)
    out.update(index_s=time.perf_counter() - t0, selected=selected)
    if with_selector != want:
        raise AssertionError('legacy index: the selector read {} rows, expected {}'.format(
            sum(with_selector.values()), sum(want.values())))
    # the migration to a native store
    migrated = 'file://' + os.path.join(work_dir, 'png_fixed_migrated')
    t0 = time.perf_counter()
    copied = copy_dataset(legacy_url, migrated, rows_per_row_group=IMAGE_ROWS_PER_ROW_GROUP,
                          workers_count=ETL_WORKERS)
    out['copy_s'] = time.perf_counter() - t0
    meta = read_metadata_dict(migrated)
    migrated_rows, _ = read_keys(migrated)
    if (copied != ROWS or UNISCHEMA_KEY not in meta
            or any(k.startswith(b'dataset-toolkit') for k in meta) or migrated_rows != expected):
        raise AssertionError('copy_dataset: {} rows copied, keys {}, rows equal: {}'.format(
            copied, sorted(meta), migrated_rows == expected))
    out['copied_rows'] = copied
    return out


def _check_listing_routes(meta_root):
    """On the 64-file copy of the day store: ``load_row_groups`` lists the
    same pieces from the stored counts, from a ``_metadata`` summary file
    with no counts stored, and from the footers; ``generate_metadata``
    writes the counts back under the stored schema, then restores a deleted
    ``_common_metadata`` with an inferred schema (the day store's fields,
    ``day`` typed int64 from the paths) and the same counts and pieces.
    Each route's seconds."""
    from petastorm_tpu_torch.etl.dataset_metadata import (ROW_GROUPS_PER_FILE_KEY, UNISCHEMA_KEY,
                                                           load_row_groups, read_metadata_dict)
    from petastorm_tpu_torch.test_util.stores import data_files, write_summary_metadata
    from petastorm_tpu_torch.tools.generate_metadata import generate_metadata

    url = 'file://' + meta_root
    seconds = {}

    def listing(route, **kwargs):
        t0 = time.perf_counter()
        pieces = load_row_groups(url, **kwargs)
        seconds[route] = time.perf_counter() - t0
        return _listing(pieces)

    counts = listing('counts')
    before = read_metadata_dict(url)
    write_summary_metadata(meta_root)
    if ROW_GROUPS_PER_FILE_KEY in read_metadata_dict(url):
        raise AssertionError('the summary copy still stores its counts')
    summary = listing('summary')
    footers = listing('footers', use_cached_metadata=False)
    files = len(data_files(meta_root))
    if not (counts == summary == footers) or files != ROWS // IMAGE_ROWS_PER_ROW_GROUP or len(
            counts) != files or {p[3]['day'] for p in counts} != set(range(DAYS)):
        raise AssertionError('load_row_groups: {} pieces by the counts, {} by the summary, {} by '
                             'the footers, over {} files'.format(len(counts), len(summary),
                                                                 len(footers), files))
    t0 = time.perf_counter()
    _, n_groups = generate_metadata(url)
    seconds['generate_metadata'] = time.perf_counter() - t0
    after = read_metadata_dict(url)
    restored = (json.loads(after[UNISCHEMA_KEY]) == json.loads(before[UNISCHEMA_KEY])
                and json.loads(after[ROW_GROUPS_PER_FILE_KEY])
                == json.loads(before[ROW_GROUPS_PER_FILE_KEY])
                and _listing(load_row_groups(url)) == counts)
    if not restored or n_groups != files:
        raise AssertionError('generate_metadata restored {} row groups; schema and counts equal '
                             'to the written ones: {}'.format(n_groups, restored))
    os.unlink(os.path.join(meta_root, '_common_metadata'))
    t0 = time.perf_counter()
    inferred, n_groups = generate_metadata(url)
    seconds['generate_metadata_inferred'] = time.perf_counter() - t0
    after = read_metadata_dict(url)
    restored = (set(inferred.fields) == set(day_schema().fields)
                and inferred.fields['day'].numpy_dtype is np.int64
                and json.loads(after[ROW_GROUPS_PER_FILE_KEY])
                == json.loads(before[ROW_GROUPS_PER_FILE_KEY])
                and _listing(load_row_groups(url)) == counts)
    if not restored or n_groups != files:
        raise AssertionError('generate_metadata restored {} row groups of a deleted '
                             '_common_metadata; inferred fields {}, counts and pieces equal to '
                             'the written ones: {}'.format(n_groups, sorted(inferred.fields),
                                                           restored))
    return {'files': files, 'pieces': len(counts), 'seconds': seconds}


def phase_etl_checks(fixed_url, work_dir, ring):
    """The store layer on the card's host, each sub-check's seconds: a
    partitioned store grown by ``append`` read through the process pool's
    in-place route; a store of the original petastorm library read, selected
    and migrated; the three routes of ``load_row_groups`` and
    ``generate_metadata``."""
    t0 = time.perf_counter()
    cells = _store_table(fixed_url, ['image']).column('image').to_pylist()
    day_url = 'file://' + os.path.join(work_dir, 'png_fixed_days')
    meta_root = os.path.join(work_dir, 'png_fixed_days_summary')
    checks = {}
    for name, check, args in (('append', _check_append, (day_url, meta_root, cells, ring)),
                              ('legacy', _check_legacy, (fixed_url, work_dir)),
                              ('listing_routes', _check_listing_routes, (meta_root,))):
        t1 = time.perf_counter()
        checks[name] = check(*args)
        checks[name]['total_s'] = time.perf_counter() - t1
    emit({'phase': 'etl_checks', 'checks': checks, 'seconds': time.perf_counter() - t0,
          'host': _host_cpu()})
    check_no_leftovers()


# -- reader compositions and adapters ------------------------------------------

#: raw_mix: the second source (image indices 1024-1279, by the raw store's
#: code) and the weights of docs/sequence.md:105
MIX_B_ROWS = 256
MIX_WEIGHTS = (7, 3)
#: raw_tail and tail_checks: the writer publishes every 2 row groups (8
#: snapshots); the follower polls every 50 ms and gives up after 120 s
#: without a snapshot
TAIL_PUBLISH_ROWS = 2 * ROWS_PER_ROW_GROUP
TAIL_POLL_S = 0.05
TAIL_IDLE_TIMEOUT_S = 120.0
#: mixture_checks: draws of each schedule step
MIX_CHECK_DRAWS = 600
#: converter_checks: 4 MiB row groups, 8 of the MNIST test split's 10000
#: rows, so that each of two shards reads some
CONVERTER_ROW_GROUP_BYTES = 4 << 20


def raw_row_keys(first, rows):
    """The keys (:func:`_row_keys`) of raw rows ``first`` to ``first + rows - 1``."""
    return {(i % NUM_CLASSES, zlib.crc32(_image(i).tobytes())) for i in range(first, first + rows)}


def check_keys(name, keys, allowed):
    """Every key of ``keys`` is one of ``allowed``."""
    bad = [key for key in keys if key not in allowed]
    if bad:
        raise AssertionError('{}: {} staged rows are rows of no source: {}'.format(
            name, len(bad), bad[:3]))


def mix_factory(b_url, mixtures):
    """``raw_mix``'s reader: ``MixtureReader([A, B], weights=[7, 3],
    seed=7)`` over ``make_reader(output='columnar')`` of the ``raw`` store (A)
    and of ``b_url`` (B), each with half the workers the path gives one
    reader; the mixture is appended to ``mixtures``."""
    def factory(url, workers_count=1, **kwargs):
        from petastorm_tpu_torch import make_reader
        from petastorm_tpu_torch.sequence import MixtureReader

        sources = []
        try:
            for source in (url, b_url):
                sources.append(make_reader(source, output='columnar',
                                           workers_count=max(1, workers_count // 2), **kwargs))
            mixed = MixtureReader(sources, weights=list(MIX_WEIGHTS), seed=SEED)
        except BaseException:
            for reader in sources:
                reader.stop()
                reader.join()
            raise
        mixtures.append(mixed)
        return mixed
    return factory


def mix_replay(draws, weights=MIX_WEIGHTS, rng=None):
    """How often each source is picked in ``draws`` draws of a
    ``MixtureReader`` with ``weights``, no source dry, its stream
    ``rng`` (``default_rng(SEED)``): its normalization, cumulative vector
    and ``searchsorted``, replayed on the host."""
    rng = np.random.default_rng(SEED) if rng is None else rng
    w = np.asarray(weights, dtype=np.float64) / float(sum(weights))
    cum = np.cumsum(w / float(w.sum()))
    counts = [0] * len(weights)
    for _ in range(draws):
        counts[min(int(np.searchsorted(cum, rng.random(), side='right')), len(weights) - 1)] += 1
    return counts


def phase_raw_mix(torch, raw_url, work_dir, raw_runs):
    """``raw_mix``: ``raw``'s trainer fed by a 7:3 mixture (:func:`mix_factory`)
    of the raw store and a second raw store of 256 rows (image indices
    1024-1279), eager and graphed. Checks: every staged row is a row of one
    of the two; each mixture's per-source rows are 64 x the source counts of
    a host replay of its draws (:func:`mix_replay`), exactly; the path
    line's stall report has a two-source ``mixture`` section. A ``mixture``
    line per run and a ``raw_mix_vs`` line beside ``raw``'s numbers of this
    call. Returns the launches."""
    b_url = 'file://' + os.path.join(work_dir, 'raw_b')
    t0 = time.perf_counter()
    build_store(b_url, first=ROWS, rows=MIX_B_ROWS)
    emit({'phase': 'store', 'store': 'raw_b', 'rows': MIX_B_ROWS,
          'bytes': _dir_bytes(b_url[len('file://'):]), 'build_s': time.perf_counter() - t0})
    b_keys = raw_row_keys(ROWS, MIX_B_ROWS)
    allowed = raw_row_keys(0, ROWS) | b_keys
    mixtures, staged = [], []

    def rows_check(keys):
        check_keys('raw_mix', keys, allowed)
        staged.append(keys)

    total, runs = run_path_both_ways(
        torch, 'raw_mix', raw_url,
        lambda images, labels: check_keys('raw_mix', _row_keys(images, labels), allowed),
        reader_factory=mix_factory(b_url, mixtures), rows_check=rows_check)
    for kind, mixed, keys in zip(('eager', 'graphed'), mixtures, staged):
        diag = mixed.diagnostics
        rows = [diag['mixture_source_{}_rows'.format(i)] for i in range(2)]
        draws = sum(rows) // ROWS_PER_ROW_GROUP
        replayed = [ROWS_PER_ROW_GROUP * n for n in mix_replay(draws)]
        stall = runs[kind][3].extra['stall']
        line = {'phase': 'mixture', 'path': 'raw_mix', 'step': kind,
                'weights': diag['mixture_weights'], 'draws': draws, 'source_rows': rows,
                'replayed_rows': replayed, 'staged_rows': len(keys),
                'staged_from_b': sum(key in b_keys for key in keys),
                'exhausted': [diag['mixture_source_{}_exhausted'.format(i)] for i in range(2)],
                'stall_mixture': stall['mixture']}
        emit(line)
        if (rows != replayed or sum(rows) % ROWS_PER_ROW_GROUP or any(line['exhausted'])
                or sorted(stall['mixture']) != [0, 1]):
            raise AssertionError('raw_mix ({}): the mixture is not its seeded replay: '
                                 '{}'.format(kind, line))
    emit({'phase': 'raw_mix_vs', 'raw_mix': path_numbers(runs), 'raw': path_numbers(raw_runs)})
    check_no_leftovers()
    return total


def tail_writer(url, out_path, rows=None):
    """The growing store of ``raw_tail`` and ``tail_checks``, written by a
    host process (``python -c 'import chip_smoke; chip_smoke.tail_writer(...)'``,
    no torch): the raw store's ``rows`` (``ROWS``) rows (:func:`raw_row`) into a fresh store
    through ``DatasetWriter`` (64 rows a row group, uncompressed),
    ``publish()`` after every 128 rows, the last with ``final=True``. Its
    numbers go to ``out_path`` as JSON."""
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter

    rows = ROWS if rows is None else rows
    t0 = time.perf_counter()
    snapshots = []
    with DatasetWriter(url, raw_schema(), rows_per_row_group=ROWS_PER_ROW_GROUP,
                       compression='none') as writer:
        for i in range(rows):
            writer.write(raw_row(i))
            if (i + 1) % TAIL_PUBLISH_ROWS == 0 or i + 1 == rows:
                snapshots.append(writer.publish(final=i + 1 == rows))
    seconds = time.perf_counter() - t0
    with open(out_path, 'w') as f:
        json.dump({'rows': rows, 'seconds': seconds, 'rows_per_s': rows / seconds,
                   'snapshots': snapshots, 'imported_torch': 'torch' in sys.modules}, f)


def spawn_tail_writer(url, out_dir):
    """:func:`tail_writer` in a host process started as the elastic hosts
    are; its log and numbers go to ``out_dir``."""
    code = 'import chip_smoke; chip_smoke.tail_writer({!r}, {!r}, rows={})'.format(
        url, os.path.join(out_dir, 'writer.json'), ROWS)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH', ''))
    with open(os.path.join(out_dir, 'writer.log'), 'ab') as log:
        return subprocess.Popen([sys.executable, '-c', code], stdout=log, stderr=log, env=env,
                                cwd=ROOT)


def reap_tail_writer(proc, out_dir):
    """Wait for the writer (killed if it is not done in 120 s); its numbers
    and its exit code."""
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    try:
        with open(os.path.join(out_dir, 'writer.json')) as f:
            numbers = json.load(f)
    except (OSError, ValueError):
        numbers = None
    if rc != 0 or numbers is None or numbers['imported_torch'] or numbers['snapshots'] != list(
            range(ROWS // TAIL_PUBLISH_ROWS)):
        with open(os.path.join(out_dir, 'writer.log')) as f:
            log = f.read()[-3000:]
        raise AssertionError('the tail writer exited {} with {}: {}'.format(rc, numbers, log))
    return numbers, rc


def tail_factory(tails):
    """``raw_tail``'s reader: ``TailFollowingReader(url, poll_interval=0.05,
    idle_timeout=120, output='columnar', **reader_kwargs)``, appended to
    ``tails``; it owns its epochs (one inner reader per snapshot delta), so
    the path's ``num_epochs`` is dropped. It counts the seconds from each
    drained delta to the next one opened: its polling (``polling_s``)."""
    from petastorm_tpu_torch.sequence import TailFollowingReader

    class TimedTail(TailFollowingReader):
        polling_s = 0.0

        def _open_next_delta(self, poll):
            t0 = time.perf_counter()
            try:
                return super(TimedTail, self)._open_next_delta(poll)
            finally:
                self.polling_s += time.perf_counter() - t0

    def factory(url, num_epochs=None, **kwargs):
        tail = TimedTail(url, poll_interval=TAIL_POLL_S, idle_timeout=TAIL_IDLE_TIMEOUT_S,
                         output='columnar', **kwargs)
        tails.append(tail)
        return tail
    return factory


def phase_raw_tail(torch, work_dir):
    """``raw_tail``: ``raw``'s trainer reading a store that a writer process
    (:func:`tail_writer`) grows and publishes meanwhile, through
    :func:`tail_factory`'s ``TailFollowingReader``; a fresh store and writer
    for each step kind, the writer started just before the trainer. Checks:
    no row key staged twice, every staged row one the writer wrote,
    ``dataset_grew`` equal to the snapshots adopted, at least 832 rows
    (the 13 steps') delivered, the writer exited 0 having imported no torch,
    and nothing left (:func:`check_no_leftovers`). A ``tail`` line per run
    (snapshots adopted, the writer's rows/s, the tail's polling seconds).
    Returns the launches."""
    written = raw_row_keys(0, ROWS)
    total = collections.Counter()
    for graphed in (False, True):
        kind = 'graphed' if graphed else 'eager'
        out_dir = tempfile.mkdtemp(prefix='tail_{}_'.format(kind), dir=work_dir)
        url = 'file://' + os.path.join(out_dir, 'store')
        tails, staged = [], []
        proc = spawn_tail_writer(url, out_dir)
        try:
            launches, _, _, batches, _, losses = run_path(
                torch, 'raw_tail', url,
                lambda images, labels: check_keys('raw_tail', _row_keys(images, labels), written),
                graphed=graphed, reader_factory=tail_factory(tails), rows_check=staged.extend)
        finally:
            writer, rc = reap_tail_writer(proc, out_dir)
        total.update(launches)
        graphed_run = (losses, batches)
        tail = tails[0]
        diag = tail.diagnostics
        adopted = diag['tail_snapshot'] + 1
        line = {'phase': 'tail', 'path': 'raw_tail', 'step': kind,
                'snapshots_adopted': adopted, 'dataset_grew': diag['dataset_grew'],
                'tail_rows_delivered': diag['tail_rows_delivered'],
                'tail_pieces_delivered': diag['tail_pieces_delivered'],
                'rows_staged': len(staged), 'distinct_rows_staged': len(set(staged)),
                'writer': writer, 'writer_rc': rc, 'tail_polling_s': tail.polling_s}
        emit(line)
        check_keys('raw_tail', staged, written)
        if (len(set(staged)) != len(staged) or diag['dataset_grew'] != adopted
                or diag['tail_rows_delivered'] < (WARMUP_STEPS + STEPS) * BATCH):
            raise AssertionError('raw_tail ({}): the tail checks failed: {}'.format(kind, line))
        shutil.rmtree(out_dir, ignore_errors=True)
    check_graphed_losses(torch, 'raw_tail', *graphed_run)
    check_no_leftovers()
    return total


def _token_sources(stack, url, **kwargs):
    """The token store split into two sources: shards 0 and 1 of 2 (8 row
    groups each), on the dummy pool in file order."""
    from petastorm_tpu_torch import make_reader

    return [stack.enter_context(make_reader(url, cur_shard=i, shard_count=2,
                                            reader_pool_type='dummy', shuffle_row_groups=False,
                                            **kwargs))
            for i in range(2)]


def _source_of(row_id):
    return (row_id // TOKENS_ROWS_PER_GROUP) % 2


def phase_mixture_checks(url, token_rows):
    """``mixture_checks`` (host): the ``collate_checks`` token store split
    into two sources (:func:`_token_sources`) with ``token_field='tokens'``.
    Checks: ``renormalize`` (7:3) delivers every row of both once; ``stop``
    ends at the first dry source, which delivered all its rows; a live
    ``set_weights([0, 1])`` after 300 rows at ``[1, 0]`` takes every later
    row from source 1; ``MixtureSchedule({0: [7, 3], 1: [5, 5]})`` sets
    ``(0.5, 0.5)`` at ``reset()`` (not a weight update), and the rows per
    source before and after it are a host replay of the draws; the token
    counts are the sums of the rows' lengths; the same seed gives the same
    interleaving twice."""
    from petastorm_tpu_torch.sequence import MixtureReader, MixtureSchedule

    t0 = time.perf_counter()
    lengths = [len(r) for r in token_rows]
    out = {}

    def renormalize():
        with contextlib.ExitStack() as stack:
            mixed = MixtureReader(_token_sources(stack, url, num_epochs=1),
                                  weights=list(MIX_WEIGHTS), seed=SEED, token_field='tokens')
            ids = [int(row.id) for row in mixed]
            return ids, mixed.diagnostics

    ids, diag = renormalize()
    tokens = [sum(lengths[i] for i in ids if _source_of(i) == s) for s in range(2)]
    out['renormalize'] = {
        'rows': len(ids), 'every_row_once': sorted(ids) == list(range(TOKENS_ROWS)),
        'source_rows': [diag['mixture_source_{}_rows'.format(s)] for s in range(2)],
        'source_tokens': [diag['mixture_source_{}_tokens'.format(s)] for s in range(2)],
        'tokens_of_rows': tokens, 'same_seed_same_order': renormalize()[0] == ids}
    with contextlib.ExitStack() as stack:
        mixed = MixtureReader(_token_sources(stack, url, num_epochs=1), weights=list(MIX_WEIGHTS),
                              seed=SEED, on_exhausted='stop')
        stop_ids = [int(row.id) for row in mixed]
        diag = mixed.diagnostics
    dry = [diag['mixture_source_{}_exhausted'.format(s)] for s in range(2)]
    stop_rows = [diag['mixture_source_{}_rows'.format(s)] for s in range(2)]
    out['stop'] = {'rows': len(stop_ids), 'exhausted': dry, 'source_rows': stop_rows,
                   'distinct': len(set(stop_ids)) == len(stop_ids)}
    with contextlib.ExitStack() as stack:
        mixed = MixtureReader(_token_sources(stack, url, num_epochs=None), weights=[1, 0],
                              seed=SEED)
        before = [_source_of(int(next(mixed).id)) for _ in range(300)]
        mixed.set_weights([0, 1])
        after = [_source_of(int(next(mixed).id)) for _ in range(300)]
        out['set_weights'] = {'before': collections.Counter(before),
                              'after': collections.Counter(after),
                              'weight_updates': mixed.diagnostics['mixture_weight_updates']}
    schedule = MixtureSchedule({0: list(MIX_WEIGHTS), 1: [5, 5]})
    rng = np.random.default_rng(SEED)
    replay = [mix_replay(MIX_CHECK_DRAWS, MIX_WEIGHTS, rng), mix_replay(MIX_CHECK_DRAWS, (5, 5),
                                                                        rng)]
    with contextlib.ExitStack() as stack:
        mixed = MixtureReader(_token_sources(stack, url, num_epochs=None), seed=SEED,
                              schedule=schedule)
        steps = []
        for epoch in range(2):
            if epoch:
                mixed.reset()
            weights = mixed.weights
            counts = collections.Counter(_source_of(int(next(mixed).id))
                                         for _ in range(MIX_CHECK_DRAWS))
            steps.append({'weights': weights, 'source_rows': [counts[0], counts[1]],
                          'replayed': replay[epoch]})
        out['schedule'] = {'epochs': steps, 'epoch': mixed.epoch,
                           'weight_updates': mixed.diagnostics['mixture_weight_updates']}
    out['seconds'] = time.perf_counter() - t0
    emit({'phase': 'mixture_checks', 'rows': TOKENS_ROWS, 'weights': MIX_WEIGHTS, **out})
    r, st, sw, sc = out['renormalize'], out['stop'], out['set_weights'], out['schedule']
    half = TOKENS_ROWS // 2
    ok = (r['every_row_once'] and r['rows'] == TOKENS_ROWS and r['source_rows'] == [half, half]
          and r['source_tokens'] == r['tokens_of_rows'] and r['same_seed_same_order']
          and sum(st['exhausted']) == 1 and st['distinct'] and st['rows'] < TOKENS_ROWS
          and st['source_rows'][st['exhausted'].index(1)] == half
          and sw['before'] == {0: 300} and sw['after'] == {1: 300} and sw['weight_updates'] == 1
          and [e['weights'] for e in sc['epochs']] == [(0.7, 0.3), (0.5, 0.5)]
          and all(e['source_rows'] == e['replayed'] for e in sc['epochs'])
          and sc['epoch'] == 1 and sc['weight_updates'] == 0)
    if not ok:
        raise AssertionError('mixture_checks failed: {}'.format(out))


def _labels_of(tail):
    return [int(label) for block in tail for label in np.atleast_1d(block.label)]


def phase_tail_checks(work_dir):
    """``tail_checks`` (host), on the label column of a raw store that a
    writer process (:func:`tail_writer`) grows: the tail (thread pool,
    shuffled) drains to the final snapshot with every row once, adopting
    all 8 snapshots; on the finished store, a ``state_dict()`` taken inside
    the second delta and a resume from it deliver the rest once; a torn
    ``snap-000008.json`` is skipped; a store whose only snapshot is not
    final raises at ``idle_timeout`` after its rows."""
    from petastorm_tpu_torch.codecs import ScalarCodec
    from petastorm_tpu_torch.errors import PetastormTpuError
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetWriter
    from petastorm_tpu_torch.sequence import TailFollowingReader, list_snapshots
    from petastorm_tpu_torch.unischema import Unischema, UnischemaField

    expected = collections.Counter(i % NUM_CLASSES for i in range(ROWS))
    out_dir = tempfile.mkdtemp(prefix='tail_checks_', dir=work_dir)
    url = 'file://' + os.path.join(out_dir, 'store')
    kwargs = {'poll_interval': TAIL_POLL_S, 'idle_timeout': TAIL_IDLE_TIMEOUT_S,
              'output': 'columnar', 'schema_fields': ['label']}
    out = {}
    t0 = time.perf_counter()
    proc = spawn_tail_writer(url, out_dir)
    try:
        with TailFollowingReader(url, shuffle_row_groups=True, seed=SEED, **kwargs) as tail:
            labels = _labels_of(tail)
            diag = tail.diagnostics
    finally:
        writer, rc = reap_tail_writer(proc, out_dir)
    out['concurrent'] = {'rows': len(labels), 'every_row_once': collections.Counter(labels)
                         == expected, 'dataset_grew': diag['dataset_grew'],
                         'tail_snapshot': diag['tail_snapshot'],
                         'tail_rows_delivered': diag['tail_rows_delivered'],
                         'tail_pieces_delivered': diag['tail_pieces_delivered'],
                         'seconds': time.perf_counter() - t0, 'writer': writer}
    serial = dict(kwargs, reader_pool_type='dummy', shuffle_row_groups=False)
    first_tail = TailFollowingReader(url, **serial)
    try:
        first = [int(label) for _ in range(3) for label in next(first_tail).label]
        state = first_tail.state_dict()
    finally:
        first_tail.stop()
        first_tail.join()
    with TailFollowingReader(url, resume_state=state, **serial) as resumed:
        rest = _labels_of(resumed)
    out['resume'] = {'first': len(first), 'rest': len(rest), 'inside_a_delta':
                     state['current_delta'] is not None and len(state['delivered']) == 2,
                     'every_row_once': collections.Counter(first + rest) == expected}
    snap_dir = os.path.join(out_dir, 'store', '_snapshots')
    with open(os.path.join(snap_dir, 'snap-000008.json'), 'w') as f:
        f.write('{"snapshot": 8, "final": true, "pie')
    with TailFollowingReader(url, **serial) as tail:
        torn_rows = len(_labels_of(tail))
    out['torn'] = {'listed': [sid for sid, _ in list_snapshots(url)], 'rows': torn_rows}
    idle_url = 'file://' + os.path.join(out_dir, 'idle')
    labels_schema = Unischema('Labels', [UnischemaField('label', np.int64, (),
                                                        ScalarCodec(np.int64), False)])
    with DatasetWriter(idle_url, labels_schema, rows_per_row_group=ROWS_PER_ROW_GROUP) as w:
        for i in range(TAIL_PUBLISH_ROWS):
            w.write({'label': np.int64(i)})
        w.publish()
    idle = {'rows': 0, 'raised': None}
    tail = TailFollowingReader(idle_url, poll_interval=TAIL_POLL_S, idle_timeout=0.5,
                               output='columnar')
    t1 = time.perf_counter()
    try:
        for block in tail:
            idle['rows'] += len(block.label)
    except PetastormTpuError as e:
        idle['raised'] = 'idle_timeout' in str(e)
    finally:
        tail.stop()
        tail.join()
    idle['seconds'] = time.perf_counter() - t1
    out['idle_timeout'] = idle
    emit({'phase': 'tail_checks', 'rows': ROWS, 'publish_every': TAIL_PUBLISH_ROWS,
          'writer_rc': rc, 'seconds': time.perf_counter() - t0, **out})
    c, r, t = out['concurrent'], out['resume'], out['torn']
    n_snaps = ROWS // TAIL_PUBLISH_ROWS
    if not (c['every_row_once'] and c['dataset_grew'] == n_snaps
            and c['tail_snapshot'] == n_snaps - 1 and c['tail_rows_delivered'] == ROWS
            and c['tail_pieces_delivered'] == ROWS // ROWS_PER_ROW_GROUP
            and r['inside_a_delta'] and r['every_row_once']
            and t['listed'] == list(range(n_snaps)) and t['rows'] == ROWS
            and idle['raised'] and idle['rows'] == TAIL_PUBLISH_ROWS and idle['seconds'] >= 0.5):
        raise AssertionError('tail_checks failed: {}'.format(out))
    shutil.rmtree(out_dir, ignore_errors=True)


def mnist_test_table(mnist_url):
    """The MNIST test split as a ``pyarrow.Table``: ``digit`` int64 and
    ``image`` list<float32> of 784 (the example's normalized pixels)."""
    import pyarrow as pa

    from petastorm_tpu_torch import make_reader

    with make_reader(mnist_url + '/test', output='columnar', num_epochs=1,
                     reader_pool_type='dummy', shuffle_row_groups=False) as reader:
        blocks = list(reader)
    digits = np.concatenate([b.digit for b in blocks]).astype(np.int64)
    images = np.concatenate([b.image for b in blocks]).reshape(len(digits), 28 * 28)
    pixels = ((images.astype(np.float32) / 255.0 - 0.1307) / 0.3081).astype(np.float32)
    offsets = np.arange(0, pixels.size + 1, 28 * 28, dtype=np.int32)
    return pa.table({'digit': pa.array(digits, pa.int64()),
                     'image': pa.ListArray.from_arrays(pa.array(offsets),
                                                       pa.array(pixels.ravel()))})


def _converter_keys(digits, images):
    return collections.Counter((int(d), zlib.crc32(np.ascontiguousarray(i, np.float32).tobytes()))
                               for d, i in zip(digits, images))


def phase_converter_checks(torch, mnist_url, work_dir, probe):
    """``converter_checks``: the MNIST test split (:func:`mnist_test_table`)
    through ``make_converter`` into a cache under the work directory (4 MiB
    row groups); a second call returns the same cache URL;
    ``make_torch_loader(batch_size=32, num_epochs=1, device='cuda')`` drives
    ``MnistCNN`` eager steps over the epoch on the card (finite losses, every
    batch on the card); ``make_torch_dataloader`` over two shards yields
    every row once; ``delete()`` removes the cache directory. Skipped, with
    a declared line, on a host without pandas, which ``make_converter``
    imports for every frame that is not a Spark one."""
    if probe['modules'].get('pandas') is None:
        emit({'phase': 'converter_checks', 'skipped': True,
              'why': 'the probe found no pandas on this host; make_converter imports it',
              'probe_modules': probe['modules']})
        return None
    from petastorm_tpu_torch.examples.mnist.torch_example import new_mnist_state
    from petastorm_tpu_torch.models.train import make_train_step
    from petastorm_tpu_torch.spark import make_converter

    t0 = time.perf_counter()
    table = mnist_test_table(mnist_url)
    parent = 'file://' + os.path.join(work_dir, 'converter')
    kwargs = {'parent_cache_dir_url': parent,
              'parquet_row_group_size_bytes': CONVERTER_ROW_GROUP_BYTES}
    conv = make_converter(table, **kwargs)
    convert_s = time.perf_counter() - t0
    again = make_converter(table, **kwargs).cache_dir_url
    state, step = new_mnist_state(MNIST_SEED, MNIST_LR), make_train_step()
    losses, devices = [], set()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with conv.make_torch_loader(batch_size=MNIST_BATCH, num_epochs=1, device='cuda') as loader:
        for batch in loader:
            devices.add(batch['image'].device.type)
            state, metrics = step(state, batch['image'].view(-1, 28, 28), batch['digit'])
            losses.append(metrics['loss'])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t1
    losses = [float(x) for x in losses]
    expected = _converter_keys(table.column('digit').to_numpy(),
                               np.stack(table.column('image').to_numpy(zero_copy_only=False)))
    seen = collections.Counter()
    for shard in range(2):
        with conv.make_torch_dataloader(batch_size=100, num_epochs=1, cur_shard=shard,
                                        shard_count=2) as loader:
            for batch in loader:
                seen.update(_converter_keys(batch['digit'].numpy(), batch['image'].numpy()))
    cache_path = conv.cache_dir_url[len('file://'):]
    existed = os.path.isdir(cache_path)
    cache_bytes = _dir_bytes(cache_path)
    conv.delete()
    line = {'phase': 'converter_checks', 'rows': len(conv), 'convert_s': convert_s,
            'cache_bytes': cache_bytes, 'same_cache_url': again == conv.cache_dir_url,
            'steps': len(losses), 'first_loss': losses[0] if losses else None,
            'last_loss': losses[-1] if losses else None, 'batch_devices': sorted(devices),
            'train_s': train_s, 'shards_every_row_once': seen == expected,
            'deleted': existed and not os.path.exists(cache_path)}
    emit(line)
    if not (line['same_cache_url'] and len(losses) == MNIST_TEST_ROWS // MNIST_BATCH
            and all(math.isfinite(x) for x in losses) and devices == {'cuda'}
            and line['shards_every_row_once'] and line['deleted']):
        raise AssertionError('converter_checks failed: {}'.format(line))
    return None


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
    from petastorm_tpu_torch.workers import ProcessPoolOptions

    builds = {'reader': NativeBuild(native_build.build), 'image': NativeBuild(native_build.build_img),
              'ring': NativeBuild(native_build.build_ring)}
    card = phase_device(torch)
    kernels = phase_kernels(torch)
    phase_bn_kernels(torch)
    work_dir = tempfile.mkdtemp(prefix='smoke_', dir=BUILD_DIR)
    example_s = {}
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
        # the raw trainer cropping 160 -> 144 inside the step, then flip and
        # normalize: the step's draws beyond the flip mask
        total.update(phase_raw_crop(torch, urls['raw'], raw))
        # the reader alone, through the throughput tool: rows, host batches
        # and staged batches beside raw's step
        phase_throughput_checks(urls['raw'], raw)
        # the raw trainer as one host of an elastic pod, through a kill and
        # a join
        total.update(phase_raw_elastic(torch, urls['raw'], work_dir, raw))
        total.update(phase_raw_mesh(torch, urls['raw']))
        # the raw trainer fed by the reader compositions: a 7:3 mixture of
        # the raw store and a second raw store, and a store a writer process
        # grows while the trainer follows it
        total.update(phase_raw_mix(torch, urls['raw'], work_dir, raw))
        total.update(phase_raw_tail(torch, work_dir))
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
        fixed_total, fixed_runs = run_path_both_ways(torch, 'png_fixed', urls['png_fixed'],
                                                     check_batch)
        total.update(fixed_total)
        # the same two stores as mock-remote stores through the chunk cache,
        # beside the local paths of this call
        remote = {}
        for name, url, runs in (('raw_remote', urls['raw'], raw),
                                ('png_fixed_remote', urls['png_fixed'], fixed_runs)):
            path_launches, remote[name] = phase_remote_path(torch, name, url, runs, work_dir)
            total.update(path_launches)
        phase_remote_checks(torch, urls['raw'], urls['png_fixed'], work_dir, ring, serve_ring)
        check_no_leftovers()
        # the raw store's chunks copied from a pod peer's mirror, beside
        # raw_remote; then the drill, the process pool, the checker and the
        # CLI of the fabric
        total.update(phase_raw_fabric(torch, urls['raw'], work_dir, remote['raw_remote']))
        phase_fabric_checks(urls['raw'], work_dir)
        check_no_leftovers()
        # the process pool: one spawned worker per core, shm rings
        process = {'reader_pool_type': ProcessPoolOptions(ring_bytes=ring, transport='shm')}
        process_runs = {}
        for name, url, check, kwargs, named in (
                ('raw_process', urls['raw'], check_batch, dict(process, zero_copy=True), None),
                ('png_process', urls['png'], png_check, dict(process, **image_kwargs),
                 routes['png'])):
            path_launches, process_runs[name] = run_path_both_ways(
                torch, name, url, check, reader_kwargs=kwargs, routes=named)
            total.update(path_launches)
            check_no_leftovers()
        # raw_process under a killed, a segfaulted and an erroring worker,
        # with the protocol monitor armed; then the verifier and the CLIs
        total.update(phase_raw_chaos(torch, urls['raw'], work_dir, process_runs['raw_process']))
        phase_monitor_checks(urls['raw'], work_dir)
        phase_diagnose_checks(urls['raw'], work_dir)
        # row filtering: a predicate on the fixed-shape PNG store, and a
        # row-group selector with shuffle-row-drop partitions on the PNG store
        from petastorm_tpu_torch.predicates import in_set
        from petastorm_tpu_torch.selectors import SingleIndexSelector
        selected_labels = {label_of(s) for s in selected_synsets()}
        filtered_runs = {}
        for name, url, check, kwargs, named, label_check in (
                ('png_fixed_pred', urls['png_fixed'], check_batch,
                 {'predicate': filter_predicates()['in_set']}, None,
                 check_labels('below {}'.format(PRED_CLASSES), lambda v: v < PRED_CLASSES)),
                ('png_select', indexed_url, png_check,
                 dict(image_kwargs, shuffle_row_drop_partitions=ROW_DROP_PARTITIONS,
                      rowgroup_selector=SingleIndexSelector('noun_id_idx', selected_synsets())),
                 routes['png'], check_labels('of a selected synset',
                                             lambda v: np.isin(v, sorted(selected_labels))))):
            path_launches, filtered_runs[name] = run_path_both_ways(
                torch, name, url, check, reader_kwargs=kwargs, routes=named,
                label_check=label_check)
            total.update(path_launches)
        # the png store Hive-partitioned by synset: the predicate on the
        # partition key prunes row groups before any worker opens a file
        part_url = 'file://' + os.path.join(work_dir, 'png_part')
        t0 = time.perf_counter()
        build_png_part_store(urls['png'], part_url)
        emit({'phase': 'store', 'store': 'png_part', 'rows': ROWS,
              'bytes': _dir_bytes(part_url[len('file://'):]), 'build_s': time.perf_counter() - t0})
        part_readers = []
        path_launches, part_runs = run_path_both_ways(
            torch, 'png_part', part_url, png_part_check(stores['png']),
            reader_kwargs=dict(image_kwargs, predicate=in_set(selected_synsets(), 'noun_id')),
            routes=routes['png'], reader_factory=png_part_factory(part_readers),
            label_check=check_labels('of a selected synset',
                                     lambda v: np.isin(v, sorted(selected_labels))))
        total.update(path_launches)
        for reader in part_readers:
            check_png_part_reader(reader)
        emit({'phase': 'png_part_vs', 'png_part': path_numbers(part_runs),
              'png': path_numbers(png_runs),
              'png_select': path_numbers(filtered_runs['png_select'])})
        phase_etl_checks(urls['png_fixed'], work_dir, ring)
        phase_tail_checks(work_dir)
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
        phase_mixture_checks(*phase_collate_checks(torch, work_dir))
        seq_url = 'file://' + os.path.join(work_dir, 'seq')
        t0 = time.perf_counter()
        seq_features = build_seq_store(seq_url)
        emit({'phase': 'store', 'store': 'seq', 'rows': SEQ_ROWS,
              'bytes': _dir_bytes(seq_url[len('file://'):]), 'build_s': time.perf_counter() - t0})
        phase_ngram_checks(seq_url, ring)
        phase_seq_paths(torch, seq_url, seq_features)
        # the sequence example's own flow beside seq_ring's, in turns
        t0 = time.perf_counter()
        phase_seq_example(torch, seq_url, seq_features)
        example_s['seq_example'] = time.perf_counter() - t0
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
        # the last device ops and MnistCNN, and the example twins
        t0 = time.perf_counter()
        mnist_url = build_mnist_store(work_dir)
        example_s['mnist_store'] = time.perf_counter() - t0
        for name, phase, args in (
                ('mnist', phase_mnist, (mnist_url,)),
                ('mnist_resume', phase_mnist_resume, (mnist_url, work_dir)),
                ('imagenet_example', phase_imagenet_example, (urls['png'],)),
                ('hello_checks', phase_hello_checks, (work_dir,)),
                ('augment_checks', phase_augment_checks, ()),
                ('converter_checks', phase_converter_checks, (mnist_url, work_dir, probe))):
            t0 = time.perf_counter()
            launches = phase(torch, *args)
            example_s[name] = time.perf_counter() - t0
            total.update(launches or {})
        emit({'phase': 'example_phases', 'seconds': example_s,
              'total_s': sum(example_s.values())})
        phase_sanitize_checks()
        phase_race_checks()
        phase_lint_checks()
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
