"""The port's static invariant linter: twin of ``petastorm_tpu/analysis/``.

The same repo-specific static pass the JAX package runs over itself, over
the port: a small AST-walking framework (:mod:`core`) plus one module per
rule family, with the JAX rule codes, messages, exit codes and scopes (the
port's ``torch/`` stands where the JAX package has ``jax/``). It is wired
into tier-1 by ``tests/test_torch_static_analysis.py``, which also holds
every rule against the JAX linter on the same inputs. PT400 differs by
design: the port's trace-once-replay-many point is the CUDA graph, not
``jax.jit``, so :mod:`capture_purity` checks capture blocks. Beside the
linter live the worker-pool protocol verifier (:mod:`protocol`) and the
interleaving explorer (:mod:`schedule`).

Rule families (see ``docs/analysis.md`` for bad/good examples):

* **PT100/PT101** lock discipline — writes to lock-guarded shared state
  outside ``with self._lock``; lock-acquisition-order cycles.
* **PT200/PT201** resource lifecycle — stop/close/join-owning types
  constructed without ``with``/``try-finally``; ``__del__``-only cleanup.
* **PT300** exception hygiene — broad handlers in data-plane modules that
  swallow without forwarding or re-raising.
* **PT400** CUDA-graph capture purity — host clock and RNG reads
  (``time.*``, ``np.random``), device syncs (``.item()``, ``.cpu()``,
  ``torch.cuda.synchronize()``) and generator reseeds inside
  ``with torch.cuda.graph(...)`` blocks and functions passed to
  ``torch.cuda.make_graphed_callables``.
* **PT500/PT501/PT502/PT503** native-buffer safety — ``np.frombuffer``/
  ``memoryview`` results escaping without a writability check or ``.copy()``;
  zero-copy page views built without a per-page bound check; unbounded
  recursion in the native C++ sources; fused batch-buffer ABI descriptors
  missing their byte-capacity fields or pointing at temporaries.
* **PT600** hashability — ``__eq__`` without ``__hash__``.
* **PT700** telemetry span hygiene — spans/stage timers opened in
  instrumented code must close on all paths (``with`` or try/finally), or
  the trace loses stages and stall attribution under-counts them.
* **PT701** BaseException containment — worker loops must not swallow
  ``BaseException``/``KeyboardInterrupt`` without re-raising, forwarding the
  exception object, or exiting the process: eaten cancellation wedges the
  pool in ways supervision cannot detect.
* **PT702** autotune action discipline — knob actuations in
  ``petastorm_tpu_torch/autotune/`` must sit inside a ``decision_span`` (every
  change leaves an explainable ``autotune.decision`` event) and pass their
  values through ``clamp()`` (no knob write can escape the config's
  explicit bounds).
* **PT703** trace-context propagation — spans on the worker/serve data path
  must inherit the propagated ``TraceContext``: no raw ``record_span``
  calls, no hand-rolled ``trace=``/``span=``/``parent=`` identity kwargs.
  An orphan span drops out of every batch's causal tree
  (docs/observability.md, "Causal tracing").
* **PT704** async-signal-safety — code reachable from a ``signal.signal``
  handler (the flight recorder's crash-footer path,
  ``observability/blackbox.py``) must not acquire locks, log, import, open
  files, or allocate through serializers/``Struct.pack``: the interrupted
  frame may hold the very lock (or be mid-``malloc``), deadlocking or
  corrupting the process the handler is trying to describe
  (``analysis/signal_safety.py``).
* **PT800/PT801** worker-pool protocol discipline — consumer switches over
  results-channel message kinds must cover every kind declared in
  ``workers/protocol.MESSAGE_KINDS`` (or carry an else); protocol
  constants/bytes may only be defined in the canonical
  ``workers/protocol.py``. The static complement of the protocol verifier
  (``petastorm_tpu_torch/analysis/protocol/``, ``docs/protocol.md``).
* **PT900/PT901/PT902** cross-language ABI conformance — every ctypes
  ``Structure`` declaring itself a mirror of a C struct is proven
  field-for-field identical under C layout rules (offsets, sizes, kinds,
  plus the ``pstpu_abi_version`` ↔ ``EXPECTED_ABI`` literal sync); every
  ``argtypes``/``restype`` declaration is checked against the ``extern "C"``
  definition it binds; every exported pointer parameter must travel with a
  capacity bound. The ABI is checked, not trusted (``analysis/abi.py``).
* **PT903/PT904** C++ overflow/bounds discipline — bounds comparisons may
  not be multiplication-form (``n * w <= cap`` wraps for corrupt ``n``;
  division-form or an explicit guard required); ``memcpy``/pointer-advance
  code must be dominated by a check naming the destination's capacity
  (``analysis/cpp_safety.py`` — the PR 6 review-bug classes, mechanized).
* **PT1100–PT1103** shared-plane borrow-checking — views into ring slots,
  blob mappings, and chunk mirrors (``try_read_zero_copy``, ``_map_blob``,
  ``mmap_chunk``, pagescan column views) are *borrows* with a producer-owned
  lifetime. PT1100: a borrow stored into longer-lived state without
  registering with the lifetime registry; PT1101: a function returning a
  borrow without a ``:borrows:`` docstring section; PT1102: a borrow
  crossing a pickle/queue/zmq/ring boundary uncopied; PT1103: a borrow's
  manual release reachable only on some paths (``analysis/lifetime.py``,
  the static half of ``native/lifetime.py``).
* **PT1300–PT1303** whole-program thread races — ONE model over all the
  concurrency domains (``analysis/races.py``): cross-module lock-order
  cycles with call-graph edge propagation (PT1300 — PT101 keeps class-local
  cycles, PT1300 owns everything deeper or wider); reads of lock-guarded
  mutable containers with no lock held, with guarded-by inference that
  follows ``self`` helper calls (PT1301); lock-guarded containers escaping
  via return/yield/store so callers mutate them un-guarded (PT1302);
  blocking calls — unbounded ``Condition.wait``/``Event.wait``, blocking
  ``queue.get/put``, ``join``, ``time.sleep``, elastic lease I/O — made
  while holding a lock (PT1303). The static half of the deterministic
  schedule explorer (``analysis/schedule/``, ``python -m
  petastorm_tpu_torch.analysis.schedule.cli``).
* **PT1200** elastic shard-map determinism — shard maps must be pure
  functions of ``(seed, epoch, members)``: wall-clock reads, module-global
  RNG draws, RNG constructors without an explicit seed, and iteration over
  raw sets are all rejected inside ``elastic/shardmap.py``. Two hosts that
  derive different maps for the same generation double-read or drop row
  groups with no error anywhere (``analysis/elastic_lints.py``).
* **PT1400** sequence sampling determinism — mixture sampling, bucket
  release and packing decisions (``sequence/``,
  ``weighted_sampling_reader.py``) must be reproducible under a fixed
  seed: wall-clock reads, module-global RNG draws and lexically-unseeded
  RNG constructors are rejected, so a training run's data order stays a
  checkpointable fact (``analysis/sequence_lints.py``).
* **PT1500** fabric socket discipline — every blocking socket primitive in
  ``petastorm_tpu_torch/fabric/`` must carry an explicit per-operation timeout
  (``settimeout`` armed in-function, or the socket arrives alongside a
  ``deadline`` parameter) and — for data-moving ops — run under an
  end-to-end ``protocol.Deadline`` budget, so one stalled peer can never
  wedge a reader thread (``analysis/fabric_lints.py``, ``docs/fabric.md``).

Suppress a single finding with ``# noqa: PT### - <reason>`` on its line;
absorb pre-existing findings with an ``analysis_baseline.json`` (see
:func:`core.load_baseline`). CLI: ``python -m petastorm_tpu_torch.analysis``
(no console script, as with the port's other CLIs).
"""

from __future__ import annotations

from petastorm_tpu_torch.analysis.abi import AbiConformanceChecker
from petastorm_tpu_torch.analysis.autotune_lints import AutotuneActionChecker
from petastorm_tpu_torch.analysis.buffers import NativeBufferChecker
from petastorm_tpu_torch.analysis.capture_purity import CapturePurityChecker
from petastorm_tpu_torch.analysis.core import (Baseline, Checker, Finding, SourceFile,
                                         collect_sources, load_baseline, run_checkers)
from petastorm_tpu_torch.analysis.cpp_safety import CppSafetyChecker
from petastorm_tpu_torch.analysis.elastic_lints import ElasticDeterminismChecker
from petastorm_tpu_torch.analysis.exceptions import (BaseExceptionContainmentChecker,
                                               ExceptionHygieneChecker)
from petastorm_tpu_torch.analysis.fabric_lints import FabricSocketChecker
from petastorm_tpu_torch.analysis.hashability import HashabilityChecker
from petastorm_tpu_torch.analysis.lifecycle import ResourceLifecycleChecker
from petastorm_tpu_torch.analysis.lifetime import LifetimeChecker
from petastorm_tpu_torch.analysis.locks import LockDisciplineChecker
from petastorm_tpu_torch.analysis.protocol_lints import ProtocolLintChecker
from petastorm_tpu_torch.analysis.races import RaceChecker
from petastorm_tpu_torch.analysis.sequence_lints import SequenceDeterminismChecker
from petastorm_tpu_torch.analysis.serve_lints import ServeActuatorChecker
from petastorm_tpu_torch.analysis.signal_safety import SignalSafetyChecker
from petastorm_tpu_torch.analysis.telemetry import TelemetrySpanChecker
from petastorm_tpu_torch.analysis.trace_lints import TraceContextChecker

#: the full first-party rule set, in rule-id order
ALL_CHECKERS = (
    LockDisciplineChecker,
    ResourceLifecycleChecker,
    ExceptionHygieneChecker,
    CapturePurityChecker,
    NativeBufferChecker,
    HashabilityChecker,
    TelemetrySpanChecker,
    BaseExceptionContainmentChecker,
    SignalSafetyChecker,
    AutotuneActionChecker,
    TraceContextChecker,
    ProtocolLintChecker,
    ServeActuatorChecker,
    AbiConformanceChecker,
    CppSafetyChecker,
    LifetimeChecker,
    ElasticDeterminismChecker,
    RaceChecker,
    SequenceDeterminismChecker,
    FabricSocketChecker,
)

#: every individual rule id the registered checkers can emit — the linter
#: meta-test (tests/test_torch_static_analysis.py) demands a committed
#: fixture pair per id under tests/torch_lint_fixtures/, so registering a
#: toothless rule fails tier-1
ALL_RULE_CODES = tuple(c for cls in ALL_CHECKERS for c in cls.rule_codes())


def run_analysis(paths, baseline=None, select=None, ignore=None,
                 keep_suppressed=False):
    """Run every checker over ``paths`` (files or directories).

    :param baseline: a :class:`core.Baseline` (or None) absorbing known findings
    :param select: iterable of rule-id prefixes (e.g. ``['PT1', 'PT500']``)
        restricting which findings are reported; None = all
    :param ignore: iterable of rule-id prefixes to suppress, applied AFTER
        ``select`` — the staged-rollout knob (``--ignore PT8`` ships a new
        family dark)
    :param keep_suppressed: keep noqa'd/baselined findings, annotated via
        :attr:`core.Finding.status` (the ``--format json`` machine mode)
    :returns: sorted list of :class:`Finding` (only ``status == 'open'`` ones
        unless ``keep_suppressed``)
    """
    sources = collect_sources(paths)
    checkers = [cls() for cls in ALL_CHECKERS]
    findings = run_checkers(checkers, sources, baseline=baseline,
                            keep_suppressed=keep_suppressed)
    if select is not None:
        prefixes = tuple(select)
        findings = [f for f in findings if f.code.startswith(prefixes)]
    if ignore is not None and tuple(ignore):
        prefixes = tuple(ignore)
        findings = [f for f in findings if not f.code.startswith(prefixes)]
    return findings


__all__ = [
    'ALL_CHECKERS', 'ALL_RULE_CODES', 'AbiConformanceChecker',
    'AutotuneActionChecker', 'Baseline',
    'BaseExceptionContainmentChecker', 'CapturePurityChecker', 'Checker',
    'CppSafetyChecker',
    'ElasticDeterminismChecker', 'ExceptionHygieneChecker',
    'FabricSocketChecker', 'Finding',
    'HashabilityChecker', 'LifetimeChecker',
    'LockDisciplineChecker',
    'NativeBufferChecker', 'ProtocolLintChecker', 'RaceChecker',
    'ResourceLifecycleChecker', 'SequenceDeterminismChecker',
    'ServeActuatorChecker', 'SignalSafetyChecker',
    'SourceFile', 'TelemetrySpanChecker', 'TraceContextChecker',
    'collect_sources', 'load_baseline', 'run_analysis', 'run_checkers',
]
