"""The JAX package's linter over the port: ``petastorm_tpu.analysis`` holds
``petastorm_tpu_torch/`` to the rules it holds ``petastorm_tpu/`` to (lock
discipline, buffer and lifetime contracts, the ABI mirrors against the C++
sources, the serve actuators' spans, ...). A finding is fixed in the code, or
suppressed at its line with ``# noqa: PTxxx - <reason>``; a suppression with
no reason is itself a finding."""

import os

from petastorm_tpu.analysis import run_analysis

import petastorm_tpu_torch

PORT_DIR = os.path.dirname(os.path.abspath(petastorm_tpu_torch.__file__))


def test_port_has_no_open_findings():
    findings = run_analysis([PORT_DIR])
    assert findings == [], '\n'.join(f.format() for f in findings)


def test_every_port_suppression_carries_a_reason():
    suppressed = [f for f in run_analysis([PORT_DIR], keep_suppressed=True)
                  if f.status != 'open']
    # the port suppresses what the JAX tree suppresses at the twin sites
    assert suppressed
    bare = []
    for root, _dirs, files in os.walk(PORT_DIR):
        for name in files:
            if not name.endswith('.py'):
                continue
            path = os.path.join(root, name)
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    if '# noqa: PT' in line:
                        tail = line.split('# noqa: ', 1)[1]
                        if ' - ' not in tail or not tail.split(' - ', 1)[1].strip():
                            bare.append('{}:{}'.format(os.path.relpath(path, PORT_DIR),
                                                       lineno))
    assert bare == []


def test_shard_map_determinism_rule_covers_the_port(tmp_path):
    """PT1200 (no wall clock, unseeded randomness or set iteration in a shard
    map) applies to the port's ``elastic/shardmap.py``, which lints clean
    above: a copy with each fault added is caught."""
    source = os.path.join(PORT_DIR, 'elastic', 'shardmap.py')
    assert run_analysis([source]) == []
    target = tmp_path / 'petastorm_tpu_torch' / 'elastic' / 'shardmap.py'
    target.parent.mkdir(parents=True)
    with open(source) as f:
        text = f.read()
    target.write_text(text + '\n\ndef _drift(members):\n    import time\n'
                      '    return time.time(), [m for m in set(members)]\n')
    codes = [f.code for f in run_analysis([str(tmp_path / 'petastorm_tpu_torch')])]
    assert codes == ['PT1200', 'PT1200']


def test_fabric_socket_rule_covers_the_port(tmp_path):
    """PT1500 (every socket operation of ``fabric/`` timeout-armed and under
    a transfer deadline) applies to the port's fabric, which lints clean
    above: a copy of the server whose accept loop lost its timeout, and of
    the client with a receive outside any deadline, are caught."""
    target = tmp_path / 'petastorm_tpu_torch' / 'fabric'
    target.mkdir(parents=True)
    for name, old, new in (
            ('server.py', '                sock.settimeout(_ACCEPT_POLL_S)\n', ''),
            ('client.py', '\n\n__all__', '\n\ndef _peek(sock):\n'
             '    sock.settimeout(1.0)\n    return sock.recv(4)\n\n\n__all__')):
        source = os.path.join(PORT_DIR, 'fabric', name)
        assert run_analysis([source]) == []
        with open(source) as f:
            text = f.read()
        assert old in text
        (target / name).write_text(text.replace(old, new))
    findings = run_analysis([str(tmp_path / 'petastorm_tpu_torch')])
    assert sorted((os.path.basename(f.path), f.code) for f in findings) == [
        ('client.py', 'PT1500'), ('server.py', 'PT1500')]
