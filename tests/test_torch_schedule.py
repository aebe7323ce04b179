"""The port's interleaving explorer (petastorm_tpu_torch.analysis.schedule):
a twin of each case of ``tests/test_schedule.py``, over the port's
scheduler, explorer, scenarios and CLI, and parity with the JAX explorer.

* **teeth** — the seeded-defect fixtures MUST fail (a torn read-modify-write,
  the pre-fix ventilator flag protocol, an ABBA deadlock).
* **soundness** — the race-free twin survives 500+ schedules with zero
  reports.
* **replayability** — same seed => byte-for-byte identical schedules;
  ``PSTPU_SCHEDULE=<schedule>`` reproduces a recorded failure exactly.
* **the floor** — every real-component scenario passes >= 300 random
  schedules plus the DFS, driving the port's ventilators, shuffling buffer,
  slot registry and autotuner (not the JAX package's).
* **parity** — on the same seeds and budgets the two explorers give the
  defect fixtures the same verdicts, first-failure schedules and race keys
  or deadlocks (the fixtures are the same pure-Python code in both
  packages), and both pass the component scenarios.

Both schedulers are imported here, at module level, while nothing has
``threading`` patched: each captures the real primitives at import. The two
explorers run one after the other, never at once (each package has its own
run mutex).
"""

import os
import re
import subprocess
import sys
import threading
import time

import pytest

from petastorm_tpu.analysis.schedule import explorer as jax_explorer
from petastorm_tpu.analysis.schedule import scenarios as jax_scenarios
from petastorm_tpu.analysis.schedule import scheduler as jax_scheduler
from petastorm_tpu_torch.analysis.schedule import scenarios
from petastorm_tpu_torch.analysis.schedule import scheduler as port_scheduler
from petastorm_tpu_torch.analysis.schedule.cli import (EXIT_CLEAN, EXIT_FINDINGS,
                                                       EXIT_INCONCLUSIVE, EXIT_USAGE, main)
from petastorm_tpu_torch.analysis.schedule.explorer import explore, replay, run_one
from petastorm_tpu_torch.analysis.schedule.scenarios import DEFECT_SCENARIOS, SCENARIOS, lookup
from petastorm_tpu_torch.analysis.schedule.scheduler import (SCHEDULE_ENV, RandomStrategy,
                                                             SchedulerError, parse_schedule)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: every real-component scenario must survive at least this many explored
#: schedules, as in the JAX package's test
SCHEDULE_FLOOR = 300

#: the classes each port scenario must construct: the port's twins
PORT_CLASSES = {
    'concurrent_ventilator': [('petastorm_tpu_torch.workers.ventilator',
                               'ConcurrentVentilator')],
    'fair_share_ventilator': [('petastorm_tpu_torch.workers.ventilator',
                               'FairShareVentilator')],
    'shuffling_buffer': [('petastorm_tpu_torch.shuffling_buffer', 'RandomShufflingBuffer')],
    'slot_registry': [('petastorm_tpu_torch.native.lifetime', 'SlotRegistry')],
    'autotune_actuator': [('petastorm_tpu_torch.autotune.controller', 'Autotuner'),
                          ('petastorm_tpu_torch.autotune.controller', 'AutotuneConfig'),
                          ('petastorm_tpu_torch.workers.ventilator', 'ConcurrentVentilator')],
}


@pytest.fixture(autouse=True, scope='module')
def _leave_no_telemetry_state():
    """The port's ventilators and autotuner count into a process-wide
    registry: switch off what this module armed and clear what it counted,
    so later files in this process see neither, and hold the module to
    leaving no thread behind."""
    from petastorm_tpu import observability as jax_obs
    from petastorm_tpu.observability import blackbox as jax_blackbox
    from petastorm_tpu_torch import observability as obs
    from petastorm_tpu_torch.observability import blackbox

    armed = (jax_blackbox.get_recorder(), blackbox.get_recorder())
    threads = set(threading.enumerate())
    yield
    if armed[0] is None:
        jax_blackbox.disable()
    if armed[1] is None:
        blackbox.disable()
    for module in (jax_obs, obs):
        module.get_registry().reset()
        module.get_ring().clear()
    deadline = time.monotonic() + 10
    while {t for t in threading.enumerate() if t not in threads and t.is_alive()}:
        assert time.monotonic() < deadline, sorted(
            t.name for t in threading.enumerate() if t not in threads)
        time.sleep(0.05)


_PORT_REPORTS = {}


def _port_report(name):
    """The port explorer's report of a real-component scenario at the
    defaults (300 random schedules, DFS budget 100), explored once per
    module: the floor and the parity cases read the same report."""
    if name not in _PORT_REPORTS:
        _PORT_REPORTS[name] = explore(SCENARIOS[name], name=name, schedules=SCHEDULE_FLOOR,
                                      dfs_budget=100)
    return _PORT_REPORTS[name]


# ---------------------------------------------------------------------------
# teeth: seeded defects must be caught within the default budget
# ---------------------------------------------------------------------------

def test_torn_counter_caught():
    report = explore(scenarios.torn_counter, name='torn_counter', schedules=SCHEDULE_FLOOR)
    assert not report.ok
    failure = report.failure
    assert failure.races, failure.describe()
    assert any(r.attr == 'value' for r in failure.races)
    assert failure.schedule  # every failure is replayable
    assert 'PSTPU_SCHEDULE' in report.describe()


def test_prefix_ventilator_flag_protocol_caught():
    report = explore(scenarios.prefix_ventilator_flags, name='prefix_ventilator_flags',
                     schedules=SCHEDULE_FLOOR)
    assert not report.ok
    raced = {r.attr for r in report.failure.races}
    assert raced & {'_stop_requested', '_completed'}, report.failure.describe()


def test_abba_deadlock_detected():
    report = explore(scenarios.abba_deadlock, name='abba_deadlock', schedules=SCHEDULE_FLOOR)
    assert not report.ok
    failure = report.failure
    assert failure.deadlock is not None, failure.describe()
    assert 'deadlock' in failure.describe()
    assert failure.schedule


# ---------------------------------------------------------------------------
# soundness: the race-free twin survives 500+ schedules
# ---------------------------------------------------------------------------

def test_safe_counter_soundness_500_schedules():
    report = explore(scenarios.safe_counter, name='safe_counter', schedules=500, dfs_budget=100)
    assert report.ok, report.failure.describe()
    assert report.schedules_run >= 500
    assert report.dfs_runs > 0  # the DFS phase actually ran


# ---------------------------------------------------------------------------
# determinism + replay
# ---------------------------------------------------------------------------

def test_same_seed_same_schedules():
    first = explore(scenarios.torn_counter, name='torn_counter', schedules=50, seed=7)
    second = explore(scenarios.torn_counter, name='torn_counter', schedules=50, seed=7)
    assert first.failure.schedule == second.failure.schedule
    assert [r.describe() for r in first.failure.races] \
        == [r.describe() for r in second.failure.races]


def test_env_replay_is_byte_for_byte():
    report = explore(scenarios.torn_counter, name='torn_counter', schedules=50)
    recorded = report.failure.schedule
    replayed = explore(scenarios.torn_counter, name='torn_counter', schedules=50,
                       environ={SCHEDULE_ENV: recorded})
    assert replayed.replayed
    assert replayed.schedules_run == 1  # one exact replay, no exploration
    assert replayed.failure.schedule == recorded
    assert [r.key() for r in replayed.failure.races] == [r.key() for r in report.failure.races]


def test_replay_helper_reproduces_failure():
    report = explore(scenarios.torn_counter, name='torn_counter', schedules=50)
    result = replay(scenarios.torn_counter, report.failure.schedule)
    assert result.schedule == report.failure.schedule
    assert [r.key() for r in result.races] == [r.key() for r in report.failure.races]


def test_replay_divergence_is_inconclusive_not_a_pass():
    # thread 9 never exists: the recorded choice is not runnable at step 0
    result = replay(scenarios.safe_counter, '9')
    assert result.divergence
    assert result.inconclusive
    assert not result.ok


def test_step_budget_exhaustion_is_inconclusive():
    _sched, result = run_one(scenarios.concurrent_ventilator, RandomStrategy(0), max_steps=3)
    assert result.steps_exhausted
    assert result.inconclusive and not result.ok


def test_parse_schedule():
    assert parse_schedule('0,1,2,0') == [0, 1, 2, 0]
    assert parse_schedule(' 3 , 4 ') == [3, 4]
    with pytest.raises(SchedulerError):
        parse_schedule('0,x,1')


def test_threading_restored_after_runs():
    """The monkeypatches are scoped to the run, failing and aborted runs
    included, and both packages' schedulers hold the real originals."""
    explore(scenarios.torn_counter, name='torn_counter', schedules=10)
    explore(scenarios.abba_deadlock, name='abba_deadlock', schedules=10)
    lock_cls = type(threading.Lock())
    assert lock_cls.__module__ in ('_thread', 'threading')
    ev = threading.Event()
    ev.set()
    assert ev.wait(timeout=1)
    for module in (port_scheduler, jax_scheduler):
        assert module._real_Lock is threading.Lock
        assert module._real_Thread is threading.Thread
        assert module._real_Condition is threading.Condition


# ---------------------------------------------------------------------------
# the floor: the port's real components, >= 300 schedules each
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_real_component_survives_schedule_floor(name):
    report = _port_report(name)
    assert report.ok, report.failure.describe()
    assert report.random_runs >= SCHEDULE_FLOOR
    assert report.dfs_runs > 0
    assert report.schedules_run >= SCHEDULE_FLOOR


def test_scenario_registry_lookup():
    assert set(SCENARIOS) & set(DEFECT_SCENARIOS) == set()
    for name in list(SCENARIOS) + list(DEFECT_SCENARIOS):
        assert callable(lookup(name))
    with pytest.raises(KeyError):
        lookup('no_such_scenario')


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_port_scenario_drives_the_port_classes(name, monkeypatch):
    # each scenario constructs the port's twins, and nothing of the JAX
    # package's components
    import importlib

    made = []

    def counting(module_name, cls_name):
        cls = getattr(importlib.import_module(module_name), cls_name)
        original = cls.__init__

        def init(self, *args, **kwargs):
            made.append((module_name, cls_name))
            original(self, *args, **kwargs)

        monkeypatch.setattr(cls, '__init__', init)

    for module_name, cls_name in PORT_CLASSES[name]:
        counting(module_name, cls_name)
        counting(module_name.replace('petastorm_tpu_torch.', 'petastorm_tpu.'), cls_name)
    _sched, result = run_one(SCENARIOS[name], RandomStrategy(0))
    assert result.ok, result.describe()
    assert sorted(set(made)) == sorted(set(PORT_CLASSES[name]))


# ---------------------------------------------------------------------------
# parity with the JAX explorer on the same seeds and budgets
# ---------------------------------------------------------------------------

def _deadlock_text(deadlock):
    """A deadlock report without object addresses and module paths: the
    threads, their names and what each is blocked on."""
    if deadlock is None:
        return None
    text = re.sub(r' at 0x[0-9a-f]+', '', deadlock)
    return re.sub(r'petastorm_tpu(_torch)?\.analysis\.schedule\.scheduler\.', '', text)


def _verdict(report):
    failure = report.failure
    out = {'ok': report.ok, 'schedules_run': report.schedules_run,
           'random_runs': report.random_runs, 'dfs_runs': report.dfs_runs}
    if failure is not None:
        out.update(schedule=failure.schedule, steps=failure.steps,
                   races=[(r.key(), r.first, r.second, r.step) for r in failure.races],
                   deadlock=_deadlock_text(failure.deadlock),
                   errors=[name for name, _err, _tb in failure.errors],
                   inconclusive=bool(failure.inconclusive))
    return out


@pytest.mark.parametrize('name', sorted(DEFECT_SCENARIOS))
def test_defect_fixture_verdicts_equal_the_jax_explorers(name):
    jax_report = jax_explorer.explore(jax_scenarios.lookup(name), name=name,
                                      schedules=SCHEDULE_FLOOR, seed=0, dfs_budget=100)
    port_report = explore(lookup(name), name=name, schedules=SCHEDULE_FLOOR, seed=0,
                          dfs_budget=100)
    assert _verdict(port_report) == _verdict(jax_report)
    assert port_report.ok == (name == 'safe_counter')
    if not port_report.ok:
        # the report names its replay handle the same way
        assert port_report.describe().splitlines()[-1] \
            == jax_report.describe().splitlines()[-1]


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_component_scenario_passes_in_both_packages(name):
    jax_report = jax_explorer.explore(jax_scenarios.SCENARIOS[name], name=name,
                                      schedules=SCHEDULE_FLOOR, seed=0, dfs_budget=100)
    port_report = _port_report(name)
    assert jax_report.ok, jax_report.failure.describe()
    assert port_report.ok, port_report.failure.describe()
    assert min(jax_report.random_runs, port_report.random_runs) >= SCHEDULE_FLOOR


# ---------------------------------------------------------------------------
# the CLI: the JAX CLI's exit-code contract
# ---------------------------------------------------------------------------

def test_cli_clean_scenario_exits_0(capsys):
    assert main(['explore', 'safe_counter', '--schedules', '20']) == EXIT_CLEAN
    assert 'safe_counter' in capsys.readouterr().out


def test_cli_finding_exits_1(capsys):
    assert main(['explore', 'torn_counter', '--schedules', '50']) == EXIT_FINDINGS
    out = capsys.readouterr().out
    assert 'race' in out
    assert 'PSTPU_SCHEDULE' in out  # the replay handle is printed


def test_cli_unknown_scenario_exits_2(capsys):
    assert main(['explore', 'no_such_scenario']) == EXIT_USAGE


def test_cli_no_subcommand_exits_2(capsys):
    assert main([]) == EXIT_USAGE


def test_cli_env_replay_needs_exactly_one_scenario(monkeypatch, capsys):
    monkeypatch.setenv(SCHEDULE_ENV, '0,1,0')
    assert main(['explore', 'torn_counter', 'safe_counter']) == EXIT_USAGE


def test_cli_env_replay_reproduces_failure(monkeypatch, capsys):
    report = explore(scenarios.torn_counter, name='torn_counter', schedules=50)
    monkeypatch.setenv(SCHEDULE_ENV, report.failure.schedule)
    assert main(['explore', 'torn_counter']) == EXIT_FINDINGS
    assert report.failure.schedule in capsys.readouterr().out


def test_cli_inconclusive_exits_3(capsys):
    assert main(['explore', 'concurrent_ventilator', '--max-steps', '3', '--schedules', '5',
                 '--dfs-budget', '0']) == EXIT_INCONCLUSIVE


def test_cli_list_catalogs_everything(capsys):
    assert main(['list']) == EXIT_CLEAN
    out = capsys.readouterr().out
    for name in list(SCENARIOS) + list(DEFECT_SCENARIOS):
        assert name in out


def test_cli_lint_mode_points_at_the_reference_linter(capsys):
    # the lint mode is the port's own PT13xx pass (its linter with --select
    # PT13), held against the JAX race CLI's lint mode on the same inputs:
    # the port's tree is clean and the PT1300 bad fixture is a finding in
    # both; a PT600 violation is out of the family; nothing of JAX is loaded
    from petastorm_tpu.analysis.schedule.cli import main as jax_main
    port_dir = os.path.join(REPO, 'petastorm_tpu_torch')
    bad = os.path.join(REPO, 'tests', 'lint_fixtures', 'PT1300', 'bad')
    outside = os.path.join(REPO, 'tests', 'lint_fixtures', 'PT600', 'bad')
    for target, expected in ((port_dir, EXIT_CLEAN), (bad, EXIT_FINDINGS),
                             (outside, EXIT_CLEAN)):
        assert main(['lint', target]) == expected, target
        ours = capsys.readouterr().out
        assert jax_main(['lint', target]) == expected, target
        assert ours == capsys.readouterr().out
    code = ('import sys\n'
            'from petastorm_tpu_torch.analysis.schedule.cli import main\n'
            'rc = main(["lint", {!r}])\n'
            'loaded = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "petastorm_tpu"))\n'
            'assert not loaded, loaded\n'
            'sys.exit(rc)\n').format(bad)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == EXIT_FINDINGS, out.stderr
    assert 'PT1300' in out.stdout and '1 finding' in out.stdout
