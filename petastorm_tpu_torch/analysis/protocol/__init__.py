"""Worker-pool protocol verifier: executable spec, exhaustive small-scope
model checker, and runtime conformance monitor (``docs/protocol.md``).

Twin of ``petastorm_tpu/analysis/protocol/``:

* :mod:`spec` — the supervision protocol (dispatch-id ownership, claim
  heartbeats, two-stage death handling, stale dropping, quiet-window sweep)
  as an explicit-state transition system with its five invariants stated as
  predicates; :mod:`serve_spec` and :mod:`elastic_spec` do the same for the
  serve fan-out and elastic resharding.
* :mod:`modelcheck` — BFS over all interleavings for small configurations
  with canonical state hashing and counterexample minimization
  (``python -m petastorm_tpu_torch.analysis.protocol.modelcheck``).
* :mod:`monitor` — the opt-in runtime hook the pools, the serve daemon and
  the elastic coordinator feed their observed events through; any sequence
  the spec rejects raises
  :class:`~petastorm_tpu_torch.errors.ProtocolViolation`.
"""

from __future__ import annotations

from petastorm_tpu_torch.analysis.protocol.modelcheck import (CheckResult, check,
                                                              format_trace, minimize_trace)
from petastorm_tpu_torch.analysis.protocol.monitor import (ProtocolMonitor,
                                                           ProtocolViolation, monitor_from_env)
from petastorm_tpu_torch.analysis.protocol.spec import (INVARIANTS, MUTATIONS, SpecConfig,
                                                        replay_into_monitor, replay_trace)

__all__ = [
    'CheckResult', 'INVARIANTS', 'MUTATIONS', 'ProtocolMonitor',
    'ProtocolViolation', 'SpecConfig', 'check', 'format_trace',
    'minimize_trace', 'monitor_from_env', 'replay_into_monitor', 'replay_trace',
]
