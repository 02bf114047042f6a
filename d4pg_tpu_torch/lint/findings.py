"""Finding records and `# jaxlint: disable=` suppression handling.

Counterpart of ``d4pg_tpu/lint/findings.py``, copied (stdlib only).
Suppression syntax:

- ``# jaxlint: disable=rule-a,rule-b`` on the flagged line suppresses
  those rules for that line only. ``disable=all`` suppresses everything.
- ``# jaxlint: disable-file=rule-a`` anywhere in a file suppresses a rule
  for the whole file (reserve for generated or deliberately-hostile code;
  fixtures in tests use inline suppressions instead).

Suppressed findings are still collected (``Finding.suppressed=True``) so
the CLI can report how many deliberate exceptions a file carries.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

_INLINE = re.compile(r"#\s*jaxlint:\s*disable=([\w\-,]+)")
_FILE = re.compile(r"#\s*jaxlint:\s*disable-file=([\w\-,]+)")


@dataclass
class Finding:
    file: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.file}:{self.line}:{self.col}: {self.rule}: {self.message}{tag}"


@dataclass
class Suppressions:
    """Per-file suppression table parsed once from source text."""

    by_line: dict[int, set[str]] = field(default_factory=dict)
    file_wide: set[str] = field(default_factory=set)

    @classmethod
    def parse(cls, source: str) -> "Suppressions":
        sup = cls()
        for i, text in enumerate(source.splitlines(), start=1):
            m = _INLINE.search(text)
            if m:
                sup.by_line.setdefault(i, set()).update(
                    r.strip() for r in m.group(1).split(",") if r.strip())
            m = _FILE.search(text)
            if m:
                sup.file_wide.update(
                    r.strip() for r in m.group(1).split(",") if r.strip())
        return sup

    def covers(self, finding: Finding) -> bool:
        if {finding.rule, "all"} & self.file_wide:
            return True
        rules = self.by_line.get(finding.line, ())
        return finding.rule in rules or "all" in rules
