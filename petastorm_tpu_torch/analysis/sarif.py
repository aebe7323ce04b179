"""SARIF 2.1.0 output for the linter (``python -m petastorm_tpu_torch.analysis --format sarif``).

SARIF (Static Analysis Results Interchange Format, OASIS standard) is the
log format CI forges ingest to annotate pull requests. One run per
invocation: the ``tool.driver`` block lists every registered rule id (so a
viewer can show the rule catalog), each finding becomes a ``result`` with a
``physicalLocation``, and suppressed findings (``# noqa`` / baseline) carry
a ``suppressions`` entry — SARIF's native way to say "present but not
actionable" (``kind: inSource`` for noqa, ``kind: external`` for the
baseline ledger). Only unsuppressed results should gate a build, matching
the CLI's exit-code contract.

The emitted document is deliberately minimal-but-valid: every property used
here is required or recommended by the 2.1.0 schema, and
``tests/test_torch_static_analysis.py`` structurally validates the output against
the subset of the schema the linter relies on.
"""

from __future__ import annotations

SARIF_VERSION = '2.1.0'
#: ``tool.driver.name`` (the JAX linter's is ``petastorm-tpu-lint``)
TOOL_NAME = 'petastorm-tpu-torch-lint'
SARIF_SCHEMA = 'https://json.schemastore.org/sarif-2.1.0.json'

#: Finding.status -> SARIF suppression kind (open findings get none)
_SUPPRESSION_KINDS = {'noqa': 'inSource', 'baselined': 'external'}


def sarif_rules(checkers):
    """The ``tool.driver.rules`` array: one reportingDescriptor per rule id,
    in registration order, plus the framework's PT000 parse-error rule."""
    rules = []
    for cls in checkers:
        for code in cls.rule_codes():
            rules.append({
                'id': code,
                'name': cls.name,
                'shortDescription': {'text': cls.description or cls.name},
            })
    rules.append({
        'id': 'PT000',
        'name': 'parse-error',
        'shortDescription': {'text': 'source file failed to parse'},
    })
    return rules


def to_sarif(findings, checkers):
    """Serialize ``findings`` (any status) into one SARIF 2.1.0 log dict."""
    rules = sarif_rules(checkers)
    rule_index = {r['id']: i for i, r in enumerate(rules)}
    results = []
    for f in findings:
        region = {'startLine': f.line}
        if f.snippet:
            region['snippet'] = {'text': f.snippet}
        result = {
            'ruleId': f.code,
            'level': 'error',
            'message': {'text': f.message},
            'locations': [{
                'physicalLocation': {
                    'artifactLocation': {'uri': f.path},
                    'region': region,
                },
            }],
        }
        if f.code in rule_index:
            result['ruleIndex'] = rule_index[f.code]
        kind = _SUPPRESSION_KINDS.get(f.status)
        if kind is not None:
            result['suppressions'] = [{'kind': kind}]
        results.append(result)
    return {
        '$schema': SARIF_SCHEMA,
        'version': SARIF_VERSION,
        'runs': [{
            'tool': {
                'driver': {
                    'name': TOOL_NAME,
                    'informationUri':
                        'https://github.com/petastorm-tpu/petastorm-tpu'
                        '/blob/main/docs/analysis.md',
                    'rules': rules,
                },
            },
            'results': results,
        }],
    }


__all__ = ['SARIF_SCHEMA', 'SARIF_VERSION', 'TOOL_NAME', 'sarif_rules', 'to_sarif']
