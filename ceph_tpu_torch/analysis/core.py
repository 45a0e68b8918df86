"""Analyzer core: AST walk, rule protocol, pragma suppression.

Design mirrors the reference's lint layering (``src/script/``'s checks
run over the whole tree, per-file, with explicit suppressions): a
:class:`Rule` sees one parsed module at a time through an
:class:`AnalysisContext` and yields :class:`Violation`\\ s; the runner
walks ``ceph_tpu_torch/``, applies every requested rule, and drops any
violation whose source line (or the line above it) carries a
``# lint: allow[rule-id]`` pragma.  Pragmas are the *audited
exception* mechanism — each one marks a site a human justified in
place; module-scope exceptions live in the rules' own allowlists
(ceph_tpu_torch/analysis/rules.py) so they are reviewed like code.
"""
from __future__ import annotations

import ast
import os
import re
import subprocess
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence

# repo layout anchors: .../ceph_tpu_torch/analysis/core.py
PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PKG_ROOT)

_PRAGMA_RE = re.compile(r"#\s*lint:\s*allow\[([^\]]*)\]")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str          # repo-relative, e.g. "ceph_tpu_torch/dispatch/batch.py"
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class AnalysisContext:
    """One module under analysis: parsed tree + source + identity."""

    def __init__(self, abspath: str, source: Optional[str] = None,
                 relpath: Optional[str] = None):
        self.abspath = abspath
        self.path = os.path.relpath(abspath, REPO_ROOT)
        # rules match on the package-relative path so fixture trees
        # analyzed from tmp dirs hit the same allowlists; tests pass
        # an explicit relpath to place a snippet anywhere in the tree
        self.relpath = relpath if relpath is not None else self.path
        if self.relpath.startswith("ceph_tpu_torch" + os.sep):
            self.relpath = self.relpath[len("ceph_tpu_torch" + os.sep):]
        if source is None:
            with open(abspath, "r", encoding="utf-8") as f:
                source = f.read()
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=abspath)
        self._imports: Optional[set] = None
        self._aliases: Optional[dict] = None

    def imported_modules(self) -> set:
        """Top-of-dotted-path module names imported anywhere in the
        file (function-local imports included — device-facing modules
        routinely defer ``import torch``)."""
        if self._imports is None:
            mods = set()
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        mods.add(a.name.split(".")[0])
                        mods.add(a.name)
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods.add(node.module.split(".")[0])
                    mods.add(node.module)
            self._imports = mods
        return self._imports

    def import_aliases(self) -> dict:
        """Local binding -> canonical dotted origin, so rules cannot
        be evaded by ``from threading import Lock`` or ``import
        threading as th``: {"Lock": "threading.Lock", "th":
        "threading"}."""
        if self._aliases is None:
            al = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        al[a.asname or a.name.split(".")[0]] = \
                            a.name if a.asname else a.name.split(".")[0]
                elif isinstance(node, ast.ImportFrom) and node.module \
                        and node.level == 0:
                    for a in node.names:
                        if a.name != "*":
                            al[a.asname or a.name] = \
                                f"{node.module}.{a.name}"
            self._aliases = al
        return self._aliases

    def resolve_call(self, node: ast.AST) -> str:
        """Canonical dotted name of a called expression with local
        import aliases expanded (``Lock()`` -> ``threading.Lock``)."""
        parts = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return ""
        root = self.import_aliases().get(cur.id, cur.id)
        return ".".join([root] + list(reversed(parts)))

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, rule_id: str, lineno: int) -> bool:
        """True when the line (or the one above, for pragmas that
        would overflow the line) allows ``rule_id``."""
        for ln in (lineno, lineno - 1):
            m = _PRAGMA_RE.search(self.line_text(ln))
            if m:
                allowed = {s.strip() for s in m.group(1).split(",")}
                if rule_id in allowed or "*" in allowed:
                    return True
        return False


class Rule:
    """A named invariant checked per module.

    Subclasses set ``id``/``doc`` and implement :meth:`check`.  A rule
    that only concerns specific files should early-return on others —
    the runner calls every rule on every module.
    """

    id: str = ""
    doc: str = ""

    def check(self, ctx: AnalysisContext) -> Iterator[Violation]:
        raise NotImplementedError

    def run(self, ctx: AnalysisContext) -> List[Violation]:
        return [v for v in self.check(ctx)
                if not ctx.suppressed(self.id, v.line)]


def iter_tree(root: Optional[str] = None) -> Iterator[str]:
    """All analyzable .py files under ``root`` (default: the
    ``ceph_tpu_torch`` package), sorted for stable output."""
    root = root or PKG_ROOT
    if os.path.isfile(root):
        yield root
        return
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for f in sorted(filenames):
            if f.endswith(".py"):
                out.append(os.path.join(dirpath, f))
    yield from out


def changed_files() -> List[str]:
    """git-diff-scoped file set for ``--changed``: working-tree +
    staged modifications plus untracked files, filtered to package
    sources."""
    paths = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "-o", "--exclude-standard"]):
        try:
            res = subprocess.run(args, cwd=REPO_ROOT, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.SubprocessError):
            continue
        if res.returncode == 0:
            paths.update(p for p in res.stdout.splitlines() if p)
    out = (os.path.join(REPO_ROOT, p) for p in paths
           if p.endswith(".py") and p.startswith("ceph_tpu_torch/"))
    # a deleted file still shows in the diff; there is nothing to parse
    return sorted(p for p in out if os.path.isfile(p))


def run_analysis(paths: Optional[Sequence[str]] = None,
                 rules: Optional[Iterable[Rule]] = None,
                 ) -> List[Violation]:
    """Run ``rules`` (default: the full catalog) over ``paths``
    (default: the whole ``ceph_tpu_torch`` tree); returns surviving
    violations sorted by location."""
    from .rules import ALL_RULES
    if rules is None:
        rules = [cls() for cls in ALL_RULES]
    files: List[str] = []
    for p in (paths or [PKG_ROOT]):
        files.extend(iter_tree(os.path.abspath(p)))
    out: List[Violation] = []
    for f in files:
        try:
            ctx = AnalysisContext(f)
        except (SyntaxError, UnicodeDecodeError) as e:
            out.append(Violation("parse-error",
                                 os.path.relpath(f, REPO_ROOT),
                                 getattr(e, "lineno", 0) or 0, str(e)))
            continue
        for rule in rules:
            out.extend(rule.run(ctx))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))
