"""The port's protocol verifier (``petastorm_tpu_torch/analysis/protocol/``)
held against the JAX package's.

* spec unit cases: states, successors, canonical hashing, trace replay;
* the model checker: ``CheckResult.to_dict()`` (less the wall time) equal in
  both packages for the small scopes, every policy and every mutation, the
  minimized counterexample included; the pool, serve and elastic default
  scopes exhausted by the port alone at the JAX state counts and above the
  floors (this file is the port's one copy of those three gates);
* the CLI's exit-code contract;
* the monitors: the same verdict and message for every crafted violation,
  seeded walks accepted by both, and the elastic walk property stated as the
  monitor can hold it.
"""

import subprocess
import sys

import pytest

from petastorm_tpu.analysis.protocol import elastic_spec as JEL
from petastorm_tpu.analysis.protocol import modelcheck as JM
from petastorm_tpu.analysis.protocol import serve_spec as JSV
from petastorm_tpu.analysis.protocol import spec as JS
from petastorm_tpu.analysis.protocol import monitor as jax_monitor
from petastorm_tpu.errors import ProtocolViolation as JaxProtocolViolation
from petastorm_tpu_torch.analysis.protocol import elastic_spec as EL
from petastorm_tpu_torch.analysis.protocol import modelcheck as M
from petastorm_tpu_torch.analysis.protocol import monitor
from petastorm_tpu_torch.analysis.protocol import serve_spec as SV
from petastorm_tpu_torch.analysis.protocol import spec as S
from petastorm_tpu_torch.errors import EmptyResultError, ProtocolViolation

TINY = dict(workers=2, items=2, crashes=1)

#: canonical states of the default scopes, as the JAX checker explores them
POOL_DEFAULT_STATES = 1_275_341
SERVE_DEFAULT_STATES = 943_900
ELASTIC_DEFAULT_STATES = 172_641

#: wall budget of each default scope: about three times its run on a loaded
#: CPU, so only a real blowup fails it
DEFAULT_BUDGET_S = 300


def _result_dict(result):
    out = result.to_dict()
    out.pop('elapsed_s')
    return out


# ---------------------------------------------------------------------------
# spec: states, transitions, canonicalization
# ---------------------------------------------------------------------------

def test_initial_state_shape():
    cfg = S.SpecConfig(**TINY)
    st = S.initial_state(cfg)
    assert st[S.NEXT_ITEM] == 0 and st[S.NEXT_D] == 0
    assert len(st[S.SLOTS]) == cfg.workers
    assert all(s[S.S_ALIVE] for s in st[S.SLOTS])
    assert S.check_state(st, cfg) is None
    assert st == JS.initial_state(JS.SpecConfig(**TINY))


def test_successors_from_init_are_dispatches():
    cfg = S.SpecConfig(**TINY)
    succ = S.successors(S.initial_state(cfg), cfg)
    assert {label[0] for label, _ in succ} <= {'dispatch', 'crash'}
    assert 'dispatch' in {label[0] for label, _ in succ}
    jcfg = JS.SpecConfig(**TINY)
    assert succ == JS.successors(JS.initial_state(jcfg), jcfg)


def test_canonicalize_slot_symmetry():
    cfg = S.SpecConfig(**TINY)
    st = S.initial_state(cfg)
    slot_busy = (1, S.WORK, 0, (), (), -1)
    slot_idle = st[S.SLOTS][0]
    a = st[:S.SLOTS] + ((slot_busy, slot_idle),) + st[S.SLOTS + 1:]
    b = st[:S.SLOTS] + ((slot_idle, slot_busy),) + st[S.SLOTS + 1:]
    assert S.canonicalize(a, cfg) == S.canonicalize(b, cfg)
    assert S.canonicalize(a, cfg) == JS.canonicalize(a, JS.SpecConfig(**TINY))


def test_canonicalize_item_symmetry():
    cfg = S.SpecConfig(**TINY)
    st = S.initial_state(cfg)
    st = st[:S.NEXT_ITEM] + (2,) + st[S.NEXT_ITEM + 1:]
    a = S._set(S._set(st, S.COMPLETED, (1, 0)), S.DELIVERED, (1, 0))
    a = S._set(a, S.COMPLETED_ITEMS, 1)
    b = S._set(S._set(st, S.COMPLETED, (0, 1)), S.DELIVERED, (0, 1))
    b = S._set(b, S.COMPLETED_ITEMS, 1)
    assert S.canonicalize(a, cfg) == S.canonicalize(b, cfg)


def test_canonicalize_renumbers_dispatch_ids():
    """Requeue histories that burned different id counts are one canonical
    state, except under a mutation, where trace and monitor ids must stay."""
    cfg = S.SpecConfig(**TINY)
    st = S.initial_state(cfg)
    st = S._set(S._set(st, S.NEXT_ITEM, 1), S.NEXT_D, 9)
    lo = S._set(st, S.INFLIGHT, ((2, 0, 0, 0),))
    hi = S._set(st, S.INFLIGHT, ((7, 0, 0, 0),))
    assert S.canonicalize(lo, cfg) == S.canonicalize(hi, cfg)
    mcfg = S.SpecConfig(mutation='requeue_same_id', **TINY)
    assert S.canonicalize(lo, mcfg) != S.canonicalize(hi, mcfg)


def test_replay_trace_validates_labels():
    cfg = S.SpecConfig(**TINY)
    trace, _final = M.random_walk(cfg, seed=7, max_steps=40)
    assert trace == JM.random_walk(JS.SpecConfig(**TINY), seed=7, max_steps=40)[0]
    state = S.canonicalize(S.initial_state(cfg), cfg)
    canonical_trace = []
    for _ in range(10):
        succ = S.successors(state, cfg)
        if not succ:
            break
        label, state = succ[0]
        canonical_trace.append(label)
    S.replay_trace(cfg, canonical_trace)
    with pytest.raises(ProtocolViolation, match='not enabled'):
        S.replay_trace(cfg, [('pickup', 0, 99)])


def test_vocabulary_equals_jax():
    assert (S.INVARIANTS, S.MUTATIONS) == (JS.INVARIANTS, JS.MUTATIONS)
    assert (SV.INVARIANTS, SV.MUTATIONS) == (JSV.INVARIANTS, JSV.MUTATIONS)
    assert (EL.INVARIANTS, EL.MUTATIONS) == (JEL.INVARIANTS, JEL.MUTATIONS)
    assert (M.DEFAULT_SCOPE, M.ERROR_SCOPE, M.DEFAULT_STATE_FLOOR) == \
        (JM.DEFAULT_SCOPE, JM.ERROR_SCOPE, JM.DEFAULT_STATE_FLOOR)
    assert (SV.DEFAULT_SERVE_SCOPE, SV.DEFAULT_SERVE_STATE_FLOOR) == \
        (JSV.DEFAULT_SERVE_SCOPE, JSV.DEFAULT_SERVE_STATE_FLOOR)
    assert (EL.DEFAULT_ELASTIC_SCOPE, EL.DEFAULT_ELASTIC_STATE_FLOOR) == \
        (JEL.DEFAULT_ELASTIC_SCOPE, JEL.DEFAULT_ELASTIC_STATE_FLOOR)


# ---------------------------------------------------------------------------
# model checker: the JAX results at the small scopes
# ---------------------------------------------------------------------------

POOL_CASES = dict(
    [('tiny', dict(TINY)), ('error_scope', dict(M.ERROR_SCOPE)),
     ('raise', dict(TINY, policy='raise', errors=1)),
     ('retry', dict(TINY, policy='retry', errors=1))]
    + [(m, dict(TINY, errors=1, mutation=m)) for m in S.MUTATIONS])


@pytest.mark.parametrize('case', sorted(POOL_CASES))
def test_check_result_equals_jax(case):
    kwargs = POOL_CASES[case]
    ours = M.check(S.SpecConfig(**kwargs), budget_s=120)
    theirs = JM.check(JS.SpecConfig(**kwargs), budget_s=120)
    assert ours.exhausted or ours.violation
    assert _result_dict(ours) == _result_dict(theirs)
    assert ours.trace == theirs.trace
    if 'mutation' in kwargs:
        assert ours.violation is not None and ours.trace
        assert M.format_trace(ours) == JM.format_trace(theirs)
    else:
        assert ours.ok and ours.states > 1_000 and ours.terminal_states >= 1


@pytest.mark.parametrize('mutation', S.MUTATIONS)
def test_mutation_counterexamples_are_minimal(mutation):
    """Removing any single step of the counterexample breaks it."""
    cfg = S.SpecConfig(mutation=mutation, errors=1, **TINY)
    result = M.check(cfg, budget_s=120)
    assert M._trace_violates(cfg, result.trace, result.violation)
    for i in range(len(result.trace)):
        assert not M._trace_violates(cfg, result.trace[:i] + result.trace[i + 1:],
                                     result.violation)


@pytest.mark.parametrize('plane,mutation',
                         [('serve', m) for m in SV.MUTATIONS]
                         + [('elastic', m) for m in EL.MUTATIONS])
def test_plane_mutations_equal_jax(plane, mutation):
    ours_mod, theirs_mod = (SV, JSV) if plane == 'serve' else (EL, JEL)
    scope = ours_mod.DEFAULT_SERVE_SCOPE if plane == 'serve' else ours_mod.DEFAULT_ELASTIC_SCOPE
    cfg_cls = 'ServeSpecConfig' if plane == 'serve' else 'ElasticSpecConfig'
    ours = ours_mod.check(getattr(ours_mod, cfg_cls)(mutation=mutation, **scope), budget_s=120)
    theirs = theirs_mod.check(getattr(theirs_mod, cfg_cls)(mutation=mutation, **scope),
                              budget_s=120)
    assert ours.violation is not None and ours.trace
    assert _result_dict(ours) == _result_dict(theirs)


# ---------------------------------------------------------------------------
# the three default scopes, exhausted by the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('plane', ['pool', 'serve', 'elastic'])
def test_default_scope_exhausts_at_jax_state_count(plane):
    if plane == 'pool':
        cfg = S.SpecConfig(**M.DEFAULT_SCOPE)
        assert cfg.workers >= 3 and cfg.items >= 4 and cfg.crashes >= 2
        result = M.check(cfg, budget_s=DEFAULT_BUDGET_S)
        expected, floor = POOL_DEFAULT_STATES, M.DEFAULT_STATE_FLOOR
    elif plane == 'serve':
        result = SV.check(SV.ServeSpecConfig(**SV.DEFAULT_SERVE_SCOPE),
                          budget_s=DEFAULT_BUDGET_S)
        expected, floor = SERVE_DEFAULT_STATES, SV.DEFAULT_SERVE_STATE_FLOOR
    else:
        result = EL.check(EL.ElasticSpecConfig(**EL.DEFAULT_ELASTIC_SCOPE),
                          budget_s=DEFAULT_BUDGET_S)
        expected, floor = ELASTIC_DEFAULT_STATES, EL.DEFAULT_ELASTIC_STATE_FLOOR
    assert result.exhausted, '{} scope not exhausted ({} states)'.format(plane, result.states)
    assert result.violation is None, result.trace
    assert result.states == expected and result.states >= floor
    assert result.terminal_states >= 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = [sys.executable, '-m', 'petastorm_tpu_torch.analysis.protocol.modelcheck']


def _cli(*args, timeout=300):
    return subprocess.run(CLI + list(args), capture_output=True, text=True, timeout=timeout)


def test_cli_exit_code_contract():
    clean = _cli('--workers', '2', '--items', '2', '--crashes', '1', '--budget-s', '120')
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert 'exhausted: all invariants hold' in clean.stdout
    bad = _cli('--workers', '2', '--items', '2', '--crashes', '1', '--errors', '1',
               '--mutate', 'requeue_same_id')
    assert bad.returncode == 1 and 'counterexample' in bad.stdout
    assert _cli('--workers', '1', '--items', '1', '--crashes', '3').returncode == 2
    floor = _cli('--workers', '2', '--items', '1', '--crashes', '1',
                 '--min-states', '99999999')
    assert floor.returncode == 3 and 'below the declared floor' in floor.stderr
    budget = _cli('--budget-s', '0.01')   # the default scope, cut short
    assert budget.returncode == 3 and 'NOT exhausted' in budget.stdout


def test_cli_planes_and_json():
    serve = _cli('--serve', '--mutate', 'reclaim_ignores_slowest')
    assert serve.returncode == 1 and 'no_overwritten_read' in serve.stdout
    elastic = _cli('--elastic', '--mutate', 'generation_rollback')
    assert elastic.returncode == 1 and 'generation_monotonic' in elastic.stdout
    assert _cli('--serve', '--elastic').returncode == 2
    out = _cli('--workers', '2', '--items', '2', '--crashes', '1', '--json')
    assert out.returncode == 0
    import json
    ours = json.loads(out.stdout)
    ours.pop('elapsed_s')
    assert ours == _result_dict(JM.check(JS.SpecConfig(**TINY)))
    # the fabric plane: its default scope exhausts clean, a mutation gives a
    # counterexample naming the invariant it breaks
    fabric = _cli('--fabric', '--min-states', '200000')
    assert fabric.returncode == 0, fabric.stdout + fabric.stderr
    assert 'fabric scope:' in fabric.stdout and 'exhausted: all invariants hold' in fabric.stdout
    broken = _cli('--fabric', '--mutate', 'no_fallback')
    assert broken.returncode == 1 and 'fetch_termination' in broken.stdout
    assert _cli('--fabric', '--serve').returncode == 2
    assert callable(M.main)


# ---------------------------------------------------------------------------
# monitors: the same verdicts and messages as the JAX package's
# ---------------------------------------------------------------------------

def _happy(m):
    m.on_dispatch(0, seq=10)
    m.on_message('claim', 0)
    m.on_message('data', 0, live=True)
    m.on_message('done', 0, live=True)
    m.on_complete(0, delivered=True)
    m.on_drained(1, 1)


def _requeue_and_stale_drop(m):
    m.on_dispatch(0)
    m.on_message('claim', 0)
    m.on_requeue(0, 1)
    m.on_message('done', 0, live=False)
    m.on_message('data', 1, live=True)
    m.on_complete(1, delivered=True)
    m.on_drained(1, 1)


def _completion_chains(m):
    m.on_dispatch(0)
    m.on_requeue(0, 1)
    m.on_dispatch(2)
    m.on_complete(1, delivered=True)
    m.on_requeue(2, 3)
    m.on_complete(3, delivered=True)


def _steps(*calls):
    def run(m):
        for name, args, kwargs in calls:
            getattr(m, name)(*args, **kwargs)
    return run


def _c(name, *args, **kwargs):
    return name, args, kwargs


#: name -> (monitor class name, scenario); each scenario raises in both
#: packages or in neither
MONITOR_CASES = {
    'happy': ('ProtocolMonitor', _happy),
    'requeue_and_stale_drop': ('ProtocolMonitor', _requeue_and_stale_drop),
    'completion_chains': ('ProtocolMonitor', _completion_chains),
    'reused_dispatch_id': ('ProtocolMonitor', _steps(_c('on_dispatch', 0),
                                                     _c('on_dispatch', 0))),
    'requeue_to_same_id': ('ProtocolMonitor', _steps(_c('on_dispatch', 0),
                                                     _c('on_requeue', 0, 0))),
    'unknown_id': ('ProtocolMonitor', _steps(_c('on_dispatch', 0),
                                             _c('on_message', 'done', 5, live=True))),
    'stale_as_live': ('ProtocolMonitor', _steps(_c('on_dispatch', 0), _c('on_requeue', 0, 1),
                                                _c('on_message', 'done', 0, live=True))),
    'live_as_stale': ('ProtocolMonitor', _steps(_c('on_dispatch', 0),
                                                _c('on_message', 'done', 0, live=False))),
    'double_completion': ('ProtocolMonitor', _steps(_c('on_dispatch', 0),
                                                    _c('on_complete', 0, delivered=True),
                                                    _c('on_complete', 0, delivered=True))),
    'requeue_after_delivery': ('ProtocolMonitor', _steps(
        _c('on_dispatch', 0), _c('on_message', 'data', 0, live=True), _c('on_requeue', 0, 1))),
    'drain_in_flight': ('ProtocolMonitor', _steps(_c('on_dispatch', 0),
                                                  _c('on_drained', 1, 1))),
    'drain_diverged': ('ProtocolMonitor', _steps(_c('on_dispatch', 0),
                                                 _c('on_complete', 0, delivered=True),
                                                 _c('on_drained', 5, 5))),
    'serve_legal_then_publish_after_end': ('ServeMonitor', _steps(
        _c('on_attach', 't0', 's0'), _c('on_publish', 's0', 0), _c('on_publish', 's0', 1),
        _c('on_evict', 't0'), _c('on_detach', 't0'), _c('on_end', 's0'),
        _c('on_publish', 's0', 2))),
    'serve_double_attach': ('ServeMonitor', _steps(_c('on_attach', 't0', 's0'),
                                                   _c('on_attach', 't0', 's0'))),
    'serve_double_publish': ('ServeMonitor', _steps(_c('on_publish', 's0', 5),
                                                    _c('on_publish', 's0', 5))),
    'serve_double_delivery': ('ServeMonitor', _steps(_c('on_deliver', 3), _c('on_deliver', 3))),
    'serve_delivery_after_end': ('ServeMonitor', _steps(_c('on_consumer_end'),
                                                        _c('on_deliver', 9))),
    'serve_detach_unknown': ('ServeMonitor', _steps(_c('on_detach', 'ghost'))),
    'elastic_double_commit': ('ElasticMonitor', _steps(
        _c('on_join', 'h0'), _c('on_join', 'h1'), _c('on_reshard', 1, ('h0', 'h1')),
        _c('on_claim', 'h0', 3), _c('on_deliver', 'h0', 3), _c('on_lease_expire', 'h1'),
        _c('on_deliver', 'h0', 3))),
    'elastic_claim_moved_early': ('ElasticMonitor', _steps(_c('on_claim', 'h0', 1),
                                                           _c('on_claim', 'h1', 1))),
    'elastic_claim_after_expiry': ('ElasticMonitor', _steps(
        _c('on_claim', 'h0', 1), _c('on_lease_expire', 'h0'), _c('on_claim', 'h1', 1),
        _c('on_deliver', 'h1', 1))),
    'elastic_generation_repeat': ('ElasticMonitor', _steps(_c('on_reshard', 2, ('h0',)),
                                                           _c('on_reshard', 2, ('h0',)))),
    'elastic_commit_unclaimed': ('ElasticMonitor', _steps(_c('on_deliver', 'h0', 4))),
    'fabric_populate_unverified': ('FabricMonitor', _steps(
        _c('on_populate', 'c0', verified=False))),
}

#: the cases the JAX package's tests require to raise, with their pattern
MONITOR_RAISES = {
    'reused_dispatch_id': 'reuses dispatch id', 'requeue_to_same_id': 'reuses dispatch id',
    'unknown_id': 'never issued', 'stale_as_live': 'retired dispatch id',
    'live_as_stale': 'dropped a .* live', 'double_completion': 'not in flight',
    'requeue_after_delivery': 'delivered', 'drain_in_flight': 'still in flight',
    'drain_diverged': 'diverge', 'serve_legal_then_publish_after_end': '',
    'serve_double_attach': '', 'serve_double_publish': '', 'serve_double_delivery': '',
    'serve_delivery_after_end': '', 'serve_detach_unknown': '',
    'elastic_double_commit': '', 'elastic_claim_moved_early': '',
    'elastic_generation_repeat': '', 'elastic_commit_unclaimed': '',
}


def _verdict(module, error, class_name, scenario):
    m = getattr(module, class_name)(name='case')
    try:
        scenario(m)
    except error as e:
        return 'raised', str(e)
    except TypeError as e:  # a scenario the class does not take
        return 'type', str(e)
    return 'accepted', None


@pytest.mark.parametrize('case', sorted(MONITOR_CASES))
def test_monitor_verdicts_and_messages_equal_jax(case):
    class_name, scenario = MONITOR_CASES[case]
    ours = _verdict(monitor, ProtocolViolation, class_name, scenario)
    theirs = _verdict(jax_monitor, JaxProtocolViolation, class_name, scenario)
    assert ours == theirs
    if case in MONITOR_RAISES:
        assert ours[0] == 'raised'
        if MONITOR_RAISES[case]:
            import re
            assert re.search(MONITOR_RAISES[case], ours[1]), ours[1]
    elif not case.startswith('fabric'):
        assert ours[0] == 'accepted'


def test_monitor_resolution_from_env(monkeypatch):
    for name in ('PSTPU_PROTOCOL_MONITOR', 'PSTPU_SERVE_MONITOR', 'PSTPU_ELASTIC_MONITOR',
                 'PSTPU_FABRIC_MONITOR'):
        monkeypatch.delenv(name, raising=False)
    resolvers = [(monitor.monitor_from_env, monitor.ProtocolMonitor, 'PSTPU_PROTOCOL_MONITOR'),
                 (monitor.serve_monitor_from_env, monitor.ServeMonitor, 'PSTPU_SERVE_MONITOR'),
                 (monitor.elastic_monitor_from_env, monitor.ElasticMonitor,
                  'PSTPU_ELASTIC_MONITOR'),
                 (monitor.fabric_monitor_from_env, monitor.FabricMonitor,
                  'PSTPU_FABRIC_MONITOR')]
    for resolve, cls, var in resolvers:
        assert resolve(None, 'x') is None and resolve(False, 'x') is None
        assert isinstance(resolve(True, 'x'), cls)
        explicit = cls(name='mine')
        assert resolve(explicit, 'x') is explicit
        monkeypatch.setenv(var, '1')
        assert isinstance(resolve(None, 'x'), cls)
        monkeypatch.setenv(var, '0')
        assert resolve(None, 'x') is None
        monkeypatch.delenv(var)
    # the umbrella variable arms every plane
    monkeypatch.setenv('PSTPU_PROTOCOL_MONITOR', '1')
    for resolve, cls, _var in resolvers:
        assert isinstance(resolve(None, 'x'), cls)


# ---------------------------------------------------------------------------
# seeded walks through both packages' monitors
# ---------------------------------------------------------------------------

WALK_CFG = dict(workers=2, items=3, crashes=1, errors=1, retries=1, policy='skip')


@pytest.mark.parametrize('seed', range(25))
def test_random_schedules_conform(seed):
    """Soundness: the monitors accept every legal schedule, the same walk in
    both packages."""
    trace, final = M.random_walk(S.SpecConfig(**WALK_CFG), seed=seed)
    assert S.check_state(final, S.SpecConfig(**WALK_CFG)) is None
    assert trace == JM.random_walk(JS.SpecConfig(**WALK_CFG), seed=seed)[0]
    ours, theirs = monitor.ProtocolMonitor(), jax_monitor.ProtocolMonitor()
    S.replay_into_monitor(trace, ours)
    JS.replay_into_monitor(trace, theirs)
    assert ours.snapshot == theirs.snapshot


def test_random_schedules_conform_hypothesis():
    hypothesis = pytest.importorskip('hypothesis')
    from hypothesis import strategies as st

    @hypothesis.given(st.integers(min_value=0, max_value=10_000))
    @hypothesis.settings(max_examples=50, deadline=None)
    def prop(seed):
        cfg = S.SpecConfig(workers=2, items=2, crashes=1, errors=1)
        trace, final = M.random_walk(cfg, seed=seed, max_steps=300)
        assert S.check_state(final, cfg) is None
        ours, theirs = monitor.ProtocolMonitor(), jax_monitor.ProtocolMonitor()
        S.replay_into_monitor(trace, ours)
        JS.replay_into_monitor(trace, theirs)
        assert ours.snapshot == theirs.snapshot

    prop()


@pytest.mark.parametrize('mutation', ['requeue_same_id', 'requeue_published',
                                      'no_stale_drop'])
def test_mutation_counterexamples_are_rejected_by_monitor(mutation):
    """What the model checker catches in the spec, both monitors catch in the
    event stream, with the same message."""
    result = M.check(S.SpecConfig(mutation=mutation, errors=1, **TINY), budget_s=120)
    with pytest.raises(ProtocolViolation) as ours:
        S.replay_into_monitor(result.trace, monitor.ProtocolMonitor(name=mutation))
    with pytest.raises(JaxProtocolViolation) as theirs:
        JS.replay_into_monitor(result.trace, jax_monitor.ProtocolMonitor(name=mutation))
    assert str(ours.value) == str(theirs.value)


#: elastic mutations whose defect shows in the event stream the monitor sees
EVENT_VISIBLE = ('generation_rollback', 'reassign_before_expiry', 'skip_done_check')


def _elastic_walk_verdict(mutation, seed):
    cfg = EL.ElasticSpecConfig(mutation=mutation, **EL.DEFAULT_ELASTIC_SCOPE)
    trace, violation = EL.random_walk(cfg, seed)
    try:
        EL.replay_into_monitor(trace, monitor.ElasticMonitor('walk'))
        raised = False
    except ProtocolViolation:
        raised = True
    return violation, raised


@pytest.mark.parametrize('mutation', [None] + list(EL.MUTATIONS))
def test_elastic_walks_replay_through_monitor(mutation):
    """The elastic spec and its runtime projection agree where the monitor
    can see the defect.

    A healthy walk replays clean. A walk of an event-visible mutation that
    reaches a violation (a generation going back, a claim moved before its
    lease expired, a second commit) makes the monitor raise. ``drop_on_expire``
    is different: it loses the expired host's in-flight row group silently.
    Nothing in the event stream is wrong (no claim moves, nothing commits
    twice); the loss shows only as ``exactly_once_coverage`` at quiescence,
    and the elastic event stream has no end-of-epoch event for the monitor
    to check coverage at. So its violating walks must show that invariant
    and pass the monitor: raising there would need an event the monitor does
    not get. Both packages give the same verdicts."""
    violating = raised = 0
    for seed in range(60):
        violation, did_raise = _elastic_walk_verdict(mutation, seed)
        jcfg = JEL.ElasticSpecConfig(mutation=mutation, **JEL.DEFAULT_ELASTIC_SCOPE)
        jtrace, jviolation = JEL.random_walk(jcfg, seed)
        assert jviolation == violation
        if mutation is None:
            assert violation is None and not did_raise
            continue
        if violation is None:
            continue
        violating += 1
        raised += did_raise
        if mutation == 'drop_on_expire':
            assert violation == 'exactly_once_coverage' and not did_raise, seed
        else:
            assert mutation in EVENT_VISIBLE and did_raise, (seed, violation)
    if mutation is not None:
        assert violating > 0, 'no seed reached the mutated behaviour'


def test_elastic_walks_replay_through_monitor_hypothesis():
    hypothesis = pytest.importorskip('hypothesis')
    from hypothesis import HealthCheck, given, settings, strategies as st

    @settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    @given(seed=st.integers(min_value=0, max_value=10 ** 6),
           mutation=st.sampled_from(sorted(EL.MUTATIONS)))
    def prop(seed, mutation):
        violation, raised = _elastic_walk_verdict(mutation, seed)
        if violation is None:
            return
        if mutation == 'drop_on_expire':
            assert violation == 'exactly_once_coverage' and not raised
        else:
            assert raised

    prop()


# ---------------------------------------------------------------------------
# the monitor on the port's pools
# ---------------------------------------------------------------------------

def _drain(pool):
    got = []
    while True:
        try:
            got.append(pool.get_results())
        except EmptyResultError:
            return got


def test_thread_pool_conforms_under_retry_policy():
    from petastorm_tpu_torch.test_util.stub_workers import ExceptionEveryNWorker
    from petastorm_tpu_torch.workers import ThreadPool
    pool = ThreadPool(2, on_error='skip', max_item_retries=1, protocol_monitor=True)
    pool.start(ExceptionEveryNWorker, worker_setup_args=3)
    for i in [1, 2, 3, 4, 5]:
        pool.ventilate(i)
    got = _drain(pool)
    pool.stop()
    pool.join()
    assert sorted(got) == [1, 2, 4, 5]
    snap = pool.protocol_monitor.snapshot
    assert snap['ventilated'] == snap['completed'] == 5 and snap['in_flight'] == []


def test_dummy_pool_conforms_and_env_var_opt_in(monkeypatch):
    from petastorm_tpu_torch.test_util.stub_workers import IdentityWorker
    from petastorm_tpu_torch.workers import DummyPool
    monkeypatch.setenv('PSTPU_PROTOCOL_MONITOR', '1')
    pool = DummyPool()
    assert pool.protocol_monitor is not None, 'the variable must arm the monitor'
    pool.start(IdentityWorker)
    for i in range(4):
        pool.ventilate(i)
    assert sorted(_drain(pool)) == list(range(4))
    pool.stop()
    pool.join()
    assert pool.protocol_monitor.snapshot['completed'] == 4
    monkeypatch.setenv('PSTPU_PROTOCOL_MONITOR', '0')
    assert DummyPool().protocol_monitor is None


def test_process_pool_conforms_with_a_crash(tmp_path):
    """A worker that dies mid-item: the claim, the death, the requeue and
    the stale drop all walk the spec."""
    from petastorm_tpu_torch.test_util.stub_workers import CrashOnceWorker
    from petastorm_tpu_torch.workers import ProcessPool
    pool = ProcessPool(2, protocol_monitor=True, results_timeout_s=60)
    pool.start(CrashOnceWorker, {'crash_on': 2, 'state_dir': str(tmp_path)})
    try:
        for i in range(6):
            pool.ventilate(i)
        got = _drain(pool)
    finally:
        pool.stop()
        pool.join()
    assert sorted(got) == list(range(6))
    assert pool.diagnostics['worker_restarts'] >= 1
    snap = pool.protocol_monitor.snapshot
    assert snap['ventilated'] == snap['completed'] == 6 and snap['in_flight'] == []
