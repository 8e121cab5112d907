"""Finding/Allowlist plumbing shared by every analyzer rule.

A Finding is one violation with a STABLE key, so the checked-in
allowlist can name it exactly and a new violation is always a diff.
Allowlist entries must carry a one-line justification and must all be
USED — a stale entry (its violation no longer exists) fails the check,
keeping the list honest in both directions.
"""

from __future__ import annotations

import fnmatch
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Finding:
    rule: str  # e.g. "blocking-under-lock"
    key: str  # stable id used for allowlisting
    message: str
    file: str = ""
    line: int = 0

    def format(self) -> str:
        loc = f"{self.file}:{self.line}: " if self.file else ""
        return f"{loc}[{self.rule}] {self.message}  (key: {self.key})"


@dataclass
class Allowlist:
    """entries: [{"rule": ..., "key": ..., "why": ...}] — key may be an
    fnmatch pattern.  Every entry must justify itself and must match at
    least one finding when `strict_unused` reporting runs."""

    entries: List[dict] = field(default_factory=list)
    path: str = ""

    def __post_init__(self):
        for e in self.entries:
            if not e.get("why", "").strip():
                raise ValueError(
                    f"allowlist entry {e.get('rule')}/{e.get('key')} in "
                    f"{self.path} has no justification ('why')"
                )

    def match(self, finding: Finding) -> Optional[dict]:
        for e in self.entries:
            if e.get("rule") not in (finding.rule, "*"):
                continue
            if fnmatch.fnmatchcase(finding.key, e.get("key", "")):
                return e
        return None

    def split(
        self, findings: List[Finding]
    ) -> Tuple[List[Finding], List[Finding], List[dict]]:
        """→ (violations, allowed, unused_entries)."""
        used: Dict[int, bool] = {}
        violations, allowed = [], []
        for f in findings:
            e = self.match(f)
            if e is None:
                violations.append(f)
            else:
                allowed.append(f)
                used[id(e)] = True
        unused = [e for e in self.entries if id(e) not in used]
        return violations, allowed, unused


def load_allowlist(path: str) -> Allowlist:
    if not os.path.exists(path):
        return Allowlist([], path)
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return Allowlist(data.get("entries", []), path)


# marker --update-manifest (and hand-copied entries) leave in a not-yet
# -reviewed justification; see todo_review_findings below
TODO_REVIEW_MARKER = "TODO review"


def todo_review_findings(allowlist: Allowlist) -> List[Finding]:
    """Entries whose `why` still contains the auto-generated
    ``TODO review`` placeholder: a justification nobody wrote yet is
    not a justification, and without this check the placeholder would
    silently become permanent."""
    out: List[Finding] = []
    for e in allowlist.entries:
        if TODO_REVIEW_MARKER in e.get("why", ""):
            out.append(
                Finding(
                    rule="todo-review-why",
                    key=f"allowlist/{e.get('rule')}/{e.get('key')}",
                    message=(
                        f"allowlist entry [{e.get('rule')}] "
                        f"{e.get('key')!r} still carries a "
                        f"'{TODO_REVIEW_MARKER}' placeholder why — write "
                        f"the real justification"
                    ),
                    file=allowlist.path,
                )
            )
    return out
