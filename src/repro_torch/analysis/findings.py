"""Findings and inline suppressions for the port's contract linter: a
copy of ``repro.analysis.findings``.

A ``Finding`` is one rule violation: rule id, location, message, and a
fix hint. Findings are the common currency of both analysis layers —
the AST rules (``ast_rules``) attach real file:line locations; the op
contracts (``contracts``) attach the entry-point name as the "path" and
line 0 (a recorded op list has no source span).

Suppression syntax (inline, justification REQUIRED)::

    x = float(n_static)  # repro: allow[host-sync-in-step] -- n is a static int

A suppression comment on its own line covers the next source line::

    # repro: allow[global-rng] -- the test's own draws, not a step's
    e = torch.randn(4)

An ``allow`` with an empty justification does not suppress anything and
is itself reported as ``bare-suppression`` (that finding cannot be
suppressed — the whole point is the recorded why).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Tuple

# rule-ids are kebab-case; the justification after ``--`` must be non-empty.
_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\[(?P<rules>[a-z0-9\-*,\s]+)\]"
    r"(?:\s*--\s*(?P<why>.*\S))?")

BARE_SUPPRESSION = "bare-suppression"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False
    justification: str = ""

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        tail = f" (hint: {self.hint})" if self.hint else ""
        mark = " [suppressed]" if self.suppressed else ""
        return f"{loc}: {self.rule}: {self.message}{tail}{mark}"


def scan_suppressions(src: str) -> Tuple[Dict[int, Dict[str, str]],
                                         List[Tuple[int, str]]]:
    """Map line number -> {rule-id: justification} for every line an
    ``allow`` covers. Returns ``(allow_map, bare)`` where ``bare`` lists
    (line, raw-comment) for allows missing a justification."""
    allow: Dict[int, Dict[str, str]] = {}
    bare: List[Tuple[int, str]] = []
    for i, text in enumerate(src.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        why = (m.group("why") or "").strip()
        if not why:
            bare.append((i, text.strip()))
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        covered = (i,) if text[:m.start()].strip() else (i, i + 1)
        for ln in covered:
            allow.setdefault(ln, {}).update({r: why for r in rules})
    return allow, bare


def apply_suppressions(findings: Iterable[Finding], src: str,
                       path: str) -> List[Finding]:
    """Mark findings covered by an inline ``allow`` as suppressed and
    append ``bare-suppression`` findings for justification-less allows."""
    allow, bare = scan_suppressions(src)
    out: List[Finding] = []
    for f in findings:
        rules = allow.get(f.line, {})
        why = rules.get(f.rule, rules.get("*"))
        if why is not None:
            f = dataclasses.replace(f, suppressed=True, justification=why)
        out.append(f)
    for line, raw in bare:
        out.append(Finding(
            rule=BARE_SUPPRESSION, path=path, line=line,
            message=f"suppression without a justification: {raw!r}",
            hint="write `# repro: allow[rule-id] -- <why this is safe>`"))
    return out
