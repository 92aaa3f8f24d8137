"""Shared infrastructure for zipnn-lint rules.

A *rule family* is a module exposing ``FAMILY`` (str) and
``check(project) -> list[Violation]``.  Families see the whole
:class:`Project` so cross-file rules (the knob-threading call graph) get
the same interface as single-file ones.

Suppression syntax (docs/INVARIANTS.md)::

    something_flagged()  # zipnn: allow(det-wallclock): reason why this is ok

A suppression covers its own line and the line directly below it (so a
comment placed above a long call suppresses the call).  The reason after
the colon is mandatory — an allow() without one is itself reported as
``bad-suppression`` and is ignored as a suppression.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_ALLOW_RE = re.compile(
    r"#\s*zipnn:\s*allow\(\s*(?P<rules>[a-zA-Z0-9_\-,\s]+)\s*\)\s*(?P<colon>:)?\s*(?P<reason>.*)$"
)


@dataclass(frozen=True)
class Violation:
    """One finding: ``path:line: [rule] message``."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    reason: str


@dataclass
class SourceFile:
    """A parsed module plus its suppression comments and a parent map."""

    rel: str  # repo-relative path, forward slashes
    text: str
    tree: ast.AST
    suppressions: List[Suppression] = field(default_factory=list)
    _parents: Optional[Dict[ast.AST, ast.AST]] = None

    @classmethod
    def parse(cls, rel: str, text: str) -> "SourceFile":
        tree = ast.parse(text, filename=rel)
        sf = cls(rel=rel, text=text, tree=tree)
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _ALLOW_RE.search(line)
            if m is None:
                continue
            rules = tuple(
                r.strip() for r in m.group("rules").split(",") if r.strip()
            )
            reason = (m.group("reason") or "").strip()
            if not m.group("colon"):
                reason = ""
            sf.suppressions.append(Suppression(lineno, rules, reason))
        return sf

    @property
    def name(self) -> str:
        return self.rel.rsplit("/", 1)[-1]

    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents().get(node)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parent(cur)
        return None


@dataclass
class Project:
    """The set of files under analysis, keyed by repo-relative path;
    ``extra`` holds the text of sources that are not Python (the CUDA
    sources the kernel contracts are read from), by repo-relative path."""

    files: List[SourceFile]
    extra: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.by_rel = {f.rel: f for f in self.files}

    def under(self, *prefixes: str) -> List[SourceFile]:
        return [
            f for f in self.files if any(f.rel.startswith(p) for p in prefixes)
        ]

    def get(self, rel: str) -> Optional[SourceFile]:
        return self.by_rel.get(rel)


# ---------------------------------------------------------------------------
# AST helpers shared by rule families
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``np.random.default_rng`` -> that string; None if not a name chain."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_tail(node: ast.Call) -> Optional[str]:
    """Final attribute/name of a call target: ``a.b.c(...)`` -> ``c``."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def is_call_to(node: ast.AST, *dotted: str) -> bool:
    """True if ``node`` is a Call whose dotted target ends with any of
    ``dotted`` (so ``numpy.random.random`` matches ``np.random.random``
    via the suffix ``random.random``)."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    if name is None:
        return False
    return any(name == d or name.endswith("." + d) for d in dotted)


def const_int(node: ast.AST) -> Optional[int]:
    if isinstance(node, ast.Constant) and isinstance(node.value, int) and not isinstance(node.value, bool):
        return node.value
    return None


def node_fingerprint(node: ast.AST) -> str:
    """Location/ctx-insensitive dump for symbolic expression equality."""
    class _Strip(ast.NodeTransformer):
        def visit(self, n: ast.AST) -> ast.AST:  # noqa: D102
            self.generic_visit(n)
            for attr in ("lineno", "col_offset", "end_lineno", "end_col_offset"):
                if hasattr(n, attr):
                    try:
                        delattr(n, attr)
                    except AttributeError:
                        pass
            if isinstance(n, (ast.Load, ast.Store, ast.Del)):
                return ast.Load()
            return n

    import copy

    return ast.dump(_Strip().visit(copy.deepcopy(node)))


# ---------------------------------------------------------------------------
# Running families + suppression filtering
# ---------------------------------------------------------------------------

def _suppressed(sf: SourceFile, v: Violation) -> bool:
    for sup in sf.suppressions:
        if not sup.reason:
            continue  # reason-less allow() never suppresses
        if sup.line in (v.line, v.line - 1) and v.rule in sup.rules:
            return True
    return False


def suppression_violations(
    project: Project, known_rules: Optional[Set[str]] = None
) -> List[Violation]:
    """``bad-suppression`` findings: missing reason, or unknown rule name."""
    out: List[Violation] = []
    for sf in project.files:
        for sup in sf.suppressions:
            if not sup.reason:
                out.append(
                    Violation(
                        "bad-suppression",
                        sf.rel,
                        sup.line,
                        "zipnn: allow(...) requires a reason — write "
                        "'# zipnn: allow(<rule>): <why this is safe>'",
                    )
                )
            if known_rules is not None:
                for r in sup.rules:
                    if r not in known_rules:
                        out.append(
                            Violation(
                                "bad-suppression",
                                sf.rel,
                                sup.line,
                                f"allow({r}) names an unknown rule",
                            )
                        )
    return out


def analyze_project(
    project: Project,
    families: Optional[Sequence] = None,
    known_rules: Optional[Set[str]] = None,
) -> List[Violation]:
    """Run rule families over ``project``; returns unsuppressed violations
    plus any ``bad-suppression`` findings, sorted by (path, line, rule)."""
    if families is None:
        families = default_families()
    raw: List[Violation] = []
    for fam in families:
        raw.extend(fam.check(project))
    if known_rules is None:
        known_rules = set()
        for fam in families:
            known_rules.update(getattr(fam, "RULES", ()))
    out: List[Violation] = []
    for v in raw:
        sf = project.get(v.path)
        if sf is not None and _suppressed(sf, v):
            continue
        out.append(v)
    out.extend(suppression_violations(project, known_rules))
    out.sort(key=lambda v: (v.path, v.line, v.rule, v.message))
    return out


def default_families() -> List:
    from . import container_spec, determinism, kernel_contract, knobs

    return [determinism, knobs, container_spec, kernel_contract]


def analyze_source(
    code: str, rel: str, families: Optional[Sequence] = None,
    extra: Optional[Dict[str, str]] = None,
) -> List[Violation]:
    """Analyze a single in-memory module as if it lived at repo path ``rel``.

    Test entry point: rule scoping is path-prefix based, so fixtures pick
    their rule exposure via the virtual path (e.g.
    ``src/repro_torch/core/fake.py`` opts into the determinism + spec scopes).
    """
    project = Project([SourceFile.parse(rel, code)], dict(extra or {}))
    return analyze_project(project, families=families)
