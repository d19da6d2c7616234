"""SARIF 2.1.0 serialization for kgct-torch-lint findings.

SARIF (Static Analysis Results Interchange Format, OASIS) is what CI
forges ingest to annotate PR diffs — one ``kgct-torch-lint --format sarif``
run gives every KGCT finding an inline review comment at its exact
file:line. The document here carries the minimal-but-valid core of the
2.1.0 schema: ``version``, one ``run`` with the tool driver (name +
full rule metadata, so viewers can render rule help without a second
source) and one ``result`` per finding with ``ruleId``, ``message`` and
a ``physicalLocation``. tests/test_torch_lint.py pins the required keys
so a refactor cannot silently ship a document GitHub rejects.
"""

from __future__ import annotations

from typing import Iterable

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def to_sarif(findings: Iterable, rules: Iterable) -> dict:
    """One SARIF 2.1.0 document (a plain dict, ``json.dumps``-ready) for
    ``findings`` produced by ``rules``. Paths are emitted as relative
    URIs with forward slashes, as the spec requires."""
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "kgct-torch-lint",
                    "informationUri": ("https://github.com/alikhabazian/"
                                       "Kubernetes-gpu-cluster"),
                    "rules": [{
                        "id": r.code,
                        "name": r.name,
                        "shortDescription": {"text": r.description},
                    } for r in rules],
                },
            },
            "results": [{
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace("\\", "/"),
                        },
                        "region": {"startLine": max(f.line, 1)},
                    },
                }],
            } for f in findings],
        }],
    }
