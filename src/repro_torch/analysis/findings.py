"""Finding model, inline-annotation allowlist, and the hash-guarded baseline.

Every checker in :mod:`repro.analysis.checkers` (and the plan-level verifier
in :mod:`repro.analysis.protocol`) reports through one shared shape — a
:class:`Finding` with a checker id, severity, ``file:line`` anchor, message
and fix hint — so the CLI, the baseline machinery and CI render them all the
same way.

Two suppression mechanisms exist, with different jobs:

* **inline annotations** document *sanctioned* behavior at the source line
  itself. The grammar is ``# repro: <checker>-ok(<reason>)`` — e.g.
  ``# repro: host-ok(restack copy-out is the mode's contract)`` — where
  ``<checker>`` is the checker's short name and the reason is mandatory (an
  empty reason is itself reported). An annotation on a ``def`` line covers
  the whole function body (for build-time helpers whose every line is
  sanctioned); otherwise it covers its own line or, as a standalone comment
  line, the line directly below.
* the **baseline** (:func:`load_baseline` / :func:`write_baseline`) grand-
  fathers *pre-existing* findings so a new checker can land without blocking
  CI on day one. Every baseline entry carries a content hash of the flagged
  line; if the line changes (or disappears) the entry goes stale and the
  lint FAILS LOUDLY instead of silently masking whatever new code now lives
  there — the annotation-drift hazard of classic lint baselines.
"""

from __future__ import annotations

import hashlib
import json
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path

__all__ = [
    "Finding",
    "Annotations",
    "line_hash",
    "scan_annotations",
    "load_baseline",
    "write_baseline",
    "apply_baseline",
    "render",
]

# annotation grammar: "# repro: <checker>-ok(<reason>)"; several annotations
# may share one comment ("# repro: host-ok(timing) donation-ok(rebound)")
_ANNOT_RE = re.compile(r"#\s*repro:\s*((?:[a-z][a-z0-9_-]*-ok\([^()]*\)\s*)+)")
_ONE_RE = re.compile(r"([a-z][a-z0-9_-]*)-ok\(([^()]*)\)")


@dataclass(frozen=True)
class Finding:
    """One checker hit, anchored to a source line (or a plan object)."""

    checker: str  # short checker id: "host", "donation", "collective", ...
    severity: str  # "error" | "warning"
    path: str  # repo-relative file path ("<plan>" for protocol findings)
    line: int  # 1-based; 0 for non-source findings
    message: str
    fix_hint: str = ""
    line_hash: str = ""  # content hash of the flagged line (baseline key)

    def anchor(self) -> str:
        return f"{self.path}:{self.line}"

    def baseline_key(self) -> tuple[str, str, str]:
        """Baseline identity: checker + file + line *content* (not number),
        so pure line-shift edits don't stale the baseline but any edit to
        the flagged line itself does."""
        return (self.checker, self.path, self.line_hash)


def line_hash(text: str) -> str:
    """Content hash of one source line, whitespace-normalized."""
    return hashlib.sha256(" ".join(text.split()).encode()).hexdigest()[:12]


@dataclass
class Annotations:
    """Allowlist extracted from one file's comments.

    ``lines`` maps a covered line number to its ``{checker: reason}``
    annotations; ``empty`` records annotations with a missing reason (these
    are surfaced as findings — a sanction without documentation is exactly
    the drift the annotation grammar exists to prevent).
    """

    lines: dict[int, dict[str, str]] = field(default_factory=dict)
    empty: list[tuple[int, str]] = field(default_factory=list)

    def allows(self, lineno: int, checker: str) -> bool:
        return checker in self.lines.get(lineno, ())


def scan_annotations(source: str, func_ranges: list[tuple[int, int]] | None = None) -> Annotations:
    """Extract ``# repro: <checker>-ok(reason)`` annotations from source.

    ``func_ranges`` are ``(def_line, end_line)`` spans; an annotation sitting
    on a ``def`` line is expanded to cover the whole function body.
    """
    ann = Annotations()
    raw: dict[int, dict[str, str]] = {}
    lines = source.splitlines()
    for i, text in enumerate(lines, start=1):
        m = _ANNOT_RE.search(text)
        if not m:
            continue
        entries = {}
        for checker, reason in _ONE_RE.findall(m.group(1)):
            reason = reason.strip()
            if not reason:
                ann.empty.append((i, checker))
                continue
            entries[checker] = reason
        if not entries:
            continue
        raw[i] = entries
        code = text[: m.start()].strip()
        if not code:
            # standalone comment line: covers the next line
            raw.setdefault(i + 1, {}).update(entries)
    # def-line annotations cover the whole function
    for start, end in func_ranges or ():
        cover = raw.get(start)
        if cover:
            for ln in range(start, end + 1):
                raw.setdefault(ln, {}).update(cover)
    ann.lines = raw
    return ann


# -- baseline --------------------------------------------------------------------


def load_baseline(path: Path) -> list[dict]:
    if not path.exists():
        return []
    data = json.loads(path.read_text())
    assert isinstance(data, dict) and "findings" in data, (
        f"{path}: baseline must be an object with a 'findings' list"
    )
    return list(data["findings"])


def write_baseline(path: Path, findings: list[Finding]) -> None:
    entries = [
        {k: v for k, v in asdict(f).items() if k in
         ("checker", "path", "line", "line_hash", "message")}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.checker))
    ]
    path.write_text(
        json.dumps(
            {
                "comment": (
                    "repro_lint baseline: grandfathered findings. Entries are "
                    "matched by (checker, path, line content hash) — editing a "
                    "baselined line invalidates its entry and the lint fails "
                    "loudly until the entry is removed or the finding fixed. "
                    "Regenerate with: python tools/repro_lint.py --all "
                    "--update-baseline"
                ),
                "findings": entries,
            },
            indent=2,
        )
        + "\n"
    )


def apply_baseline(
    findings: list[Finding], baseline: list[dict], repo_root: Path
) -> tuple[list[Finding], list[Finding], list[str]]:
    """Split findings into (new, suppressed) and detect stale entries.

    A baseline entry suppresses at most one finding with a matching
    (checker, path, line_hash). Entries that match no current finding are
    *stale* in one of two ways, both reported: the flagged line no longer
    exists anywhere in the file (fixed — remove the entry), or the line text
    changed (the hash matches nothing — the entry may now be masking a
    different violation, so it must be re-audited). Either way the lint
    fails until the baseline is regenerated, never silently.
    """
    budget: dict[tuple, int] = {}
    for e in baseline:
        key = (e["checker"], e["path"], e["line_hash"])
        budget[key] = budget.get(key, 0) + 1
    new: list[Finding] = []
    suppressed: list[Finding] = []
    for f in findings:
        key = f.baseline_key()
        if budget.get(key, 0) > 0:
            budget[key] -= 1
            suppressed.append(f)
        else:
            new.append(f)
    stale: list[str] = []
    for e in baseline:
        key = (e["checker"], e["path"], e["line_hash"])
        if budget.get(key, 0) <= 0:
            continue  # fully consumed by current findings
        src = repo_root / e["path"]
        hashes = (
            {line_hash(l) for l in src.read_text().splitlines()}
            if src.exists()
            else set()
        )
        if e["line_hash"] in hashes:
            # line still exists but the checker no longer flags it: fixed
            stale.append(
                f"{e['path']}: baseline entry for [{e['checker']}] no longer "
                f"fires (line {e.get('line', '?')}) — remove it"
            )
        else:
            stale.append(
                f"{e['path']}: STALE baseline entry [{e['checker']}] — the "
                f"flagged line (hash {e['line_hash']}) was edited or removed; "
                "re-audit and regenerate the baseline"
            )
    return new, suppressed, stale


def render(f: Finding) -> str:
    hint = f"  [fix: {f.fix_hint}]" if f.fix_hint else ""
    return f"{f.anchor()}: {f.severity}: [{f.checker}] {f.message}{hint}"
