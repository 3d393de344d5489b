"""Analysis of the port's train step: the collective inventory, the four
`hlo-*` rules and the signature manifest (`analysis/hlo.py`).

The counterpart of the `--hlo` mode of `tf_operator_tpu/analysis`: the
same rule ids, the same `# lint: allow(<rule>)` suppression comment, the
same findings document and manifest diff.  This module keeps its own copies
of what that package shares between its passes (`Finding`, the suppression
comments, `write_findings_json`, `diff_summary`).

    python -m tf_operator_tpu_torch.analysis --hlo lm|resnet|bert|vit|all|FIXTURE.py
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Dict, List, Set

FINDINGS_JSON_VERSION = 2
FINDINGS_JSON_SCHEMA = "tf-operator-tpu/lint-findings"

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\(([a-z><A-Z_-]+)\)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str

    def render(self, prefix: str = "") -> str:
        where = f"{prefix}{self.path}" if prefix else self.path
        return f"{where}:{self.line}: [{self.rule}] {self.message}"


class _Comments:
    """Per-line `# lint: allow(<rule>)` suppressions of a source file."""

    def __init__(self, source: str) -> None:
        self.allow: Dict[int, Set[str]] = {}
        for lineno, text in enumerate(source.splitlines(), start=1):
            if "#" not in text:
                continue
            for match in _ALLOW_RE.finditer(text):
                self.allow.setdefault(lineno, set()).add(match.group(1))

    def allows(self, lineno: int, rule: str) -> bool:
        return rule in self.allow.get(lineno, ())


def rule_doc(rule: str) -> str:
    """Where a rule is documented: the `hlo-*` rules in `analysis/hlo.py`."""
    return f"tf_operator_tpu_torch/analysis/hlo.py#{rule}"


def write_findings_json(path: str, findings: List[Finding],
                        target: str) -> None:
    """The findings document of the JAX package's analysis, schema v2:
    {version, schema, target, count, findings[]}, each finding {rule, path,
    line, message, severity, rule_doc}.  Every `hlo-*` rule is an error."""
    doc = {
        "version": FINDINGS_JSON_VERSION,
        "schema": FINDINGS_JSON_SCHEMA,
        "target": target,
        "count": len(findings),
        "findings": [
            {"rule": f.rule, "path": f.path, "line": f.line,
             "message": f.message, "severity": "error",
             "rule_doc": rule_doc(f.rule)}
            for f in findings
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def diff_summary(committed, regenerated, prefix: str = "") -> List[str]:
    """Human-readable recursive diff of two manifest documents."""
    lines: List[str] = []
    if isinstance(committed, dict) and isinstance(regenerated, dict):
        for key in sorted(set(committed) | set(regenerated), key=str):
            sub = f"{prefix}.{key}" if prefix else str(key)
            if key not in committed:
                lines.append(f"{sub}: only in regenerated manifest")
            elif key not in regenerated:
                lines.append(f"{sub}: only in committed manifest")
            else:
                lines.extend(diff_summary(committed[key], regenerated[key],
                                          sub))
    elif committed != regenerated:
        lines.append(f"{prefix}: committed {committed!r} != "
                     f"regenerated {regenerated!r}")
    return lines
