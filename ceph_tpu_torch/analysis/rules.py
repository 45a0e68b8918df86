"""The invariant rule catalog.

Every rule here encodes a contract an earlier PR established by
convention and until now enforced only by whichever runtime test
happened to sample it:

- **no-bare-lock** — every lock in the tree must be a *named*
  ``common.lockdep`` lock so the lock-order witness is structurally
  universal (the reference builds every Mutex through
  ``ceph::make_mutex`` for exactly this reason).
- **no-untracked-sync** — the "zero added device syncs" invariant the
  fence-count test samples becomes a whole-tree guarantee: sync
  primitives (``torch.cuda.synchronize``, ``.synchronize()`` on an
  event or stream, and ``.item()``/``.cpu()``/``.tolist()``/``.numpy()``
  in a torch-importing module) only in the audited fence/drain/devprof
  call-site modules.
- **no-wall-clock** — deterministic-fabric modules (cluster, msg,
  mon, osd) take time as a tick parameter; stray wall reads are how
  election timing went load-sensitive.
- **no-wire-drift** — the wire format is pinned by the reference's
  encoding corpus; this rule pins the *field lists* of every Message subclass
  against a checked-in manifest so drift fails lint before it can
  fail (or silently skew) the corpus.
- **jit-cache-hygiene** — the compile and capture points
  (``torch.compile``, ``torch.jit.script``/``trace``,
  ``torch.cuda.CUDAGraph``/``torch.cuda.graph``, and the
  ``ctypes.CDLL`` load of a built kernel library in ``ops/_build``)
  must be build-once (module level, ``__init__``, a recognized plan
  constructor, or a memoized assign to ``self`` or a module-level
  cache), preventing the hot-path rebuild leaks the plan caches were
  built to avoid.
- **options-doc-coverage** — every option registered in
  ``common/config.py`` is documented under ``docs/``; the allowlist
  below is one-time and closed (new options cannot join it).

Module-scope exceptions live in the ``*_ALLOWED`` constants here;
line-scope exceptions use ``# lint: allow[rule-id]`` pragmas at the
site.  Both are audited-in-review mechanisms, not escape hatches —
see docs/ANALYSIS.md for the policy.
"""
from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .core import REPO_ROOT, AnalysisContext, Rule, Violation

WIRE_MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "wire_manifest.json")


def _call_name(node: ast.Call) -> str:
    """Trailing name of the called thing: ``torch.cuda.synchronize`` ->
    ``synchronize``."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name for Name/Attribute chains."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def _path_allowed(relpath: str, allowed: Tuple[str, ...]) -> bool:
    rp = relpath.replace(os.sep, "/")
    for a in allowed:
        if a.endswith("/"):
            if rp.startswith(a):
                return True
        elif rp == a:
            return True
    return False


# ---------------------------------------------------------------------------
# no-bare-lock
# ---------------------------------------------------------------------------

# the witness's own internals are the only place a raw primitive may
# live (lockdep cannot witness itself without recursing)
BARE_LOCK_ALLOWED = ("common/lockdep.py",)


class NoBareLockRule(Rule):
    id = "no-bare-lock"
    doc = ("threading.Lock()/RLock() must be a named common.lockdep "
           "DebugLock/DebugRLock so the lock-order witness covers it")

    def check(self, ctx: AnalysisContext) -> Iterator[Violation]:
        if _path_allowed(ctx.relpath, BARE_LOCK_ALLOWED):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = ctx.resolve_call(node.func)
            if dn in ("threading.Lock", "threading.RLock"):
                kind = dn.split(".")[1]
                repl = "DebugLock" if kind == "Lock" else "DebugRLock"
                yield Violation(
                    self.id, ctx.path, node.lineno,
                    f"bare threading.{kind}() — use a named "
                    f"common.lockdep.{repl} so the lock-order witness "
                    f"sees it")
            elif dn == "threading.Condition" and not node.args:
                yield Violation(
                    self.id, ctx.path, node.lineno,
                    "zero-arg threading.Condition() creates a hidden "
                    "bare RLock — pass a named DebugLock")


# ---------------------------------------------------------------------------
# no-untracked-sync
# ---------------------------------------------------------------------------

# the audited fence/drain/devprof call-site modules: every
# host<->device boundary in these is (or routes through) a named
# devprof call site, so a sync here is *tracked* by construction
SYNC_ALLOWED = (
    "ops/",                    # device kernels: the accounted boundary
    "parallel/",               # sharded kernels (mesh collectives)
    "mesh/",                   # mesh runtime: devprof-accounted flush
    "bench/",                  # fence harness: drains are its job
    "dispatch/batch.py",       # batch assembly: accounted pad/stack/d2h
    "trace/devprof.py",        # the profiler itself
    "common/kernel_trace.py",  # opt-in timing fence (sync is the point)
    "arch.py",                 # one-shot capability probe
    "ec/shec.py",              # SHEC device decode call site
    "osdmap/mapping.py",       # CRUSH device mapper d2h boundary
    "os_store/device_shard.py",  # DeviceShard materialize: accounted
                                 # d2h at memstore.fetch_shard
)

# torch.cuda.synchronize() and Event/Stream.synchronize() wait for the
# card wherever they run; the tensor-to-host fetches wait for it only
# when the tensor lives there, so they are suspect in torch-importing
# modules alone
_SYNC_PRIMITIVES = ("synchronize",)
_HOST_FETCH = ("item", "cpu", "tolist", "numpy")


class NoUntrackedSyncRule(Rule):
    id = "no-untracked-sync"
    doc = ("device syncs (torch.cuda.synchronize / .synchronize() / "
           ".item() .cpu() .tolist() .numpy() in a torch-importing "
           "module) only inside the allowlisted fence/drain/devprof "
           "call-site modules")

    def check(self, ctx: AnalysisContext) -> Iterator[Violation]:
        if _path_allowed(ctx.relpath, SYNC_ALLOWED):
            return
        device_facing = "torch" in ctx.imported_modules()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name in _SYNC_PRIMITIVES:
                yield Violation(
                    self.id, ctx.path, node.lineno,
                    f"{name}() is a device sync — route it through an "
                    f"allowlisted fence/drain/devprof call-site module")
            elif device_facing and name in _HOST_FETCH and \
                    isinstance(node.func, ast.Attribute):
                yield Violation(
                    self.id, ctx.path, node.lineno,
                    f".{name}() in a torch-importing module is a "
                    f"potential hidden d2h sync — move the fetch "
                    f"to an accounted call-site module")


# ---------------------------------------------------------------------------
# no-wall-clock
# ---------------------------------------------------------------------------

# the deterministic fabric: these modules take time as a tick/now
# parameter; reading the wall directly makes behavior depend on host
# scheduling (the loadflaky election-timing lesson)
WALL_CLOCK_SCOPE = ("cluster.py", "msg/", "mon/", "osd/")
# real-socket transport: kernel select/connect timeouts are wall-bound
# by nature — the ONLY fabric module allowed to read the wall wholesale
WALL_CLOCK_ALLOWED = ("msg/tcp.py",)

_WALL_READS = ("time.time", "time.monotonic", "datetime.now",
               "datetime.utcnow", "datetime.datetime.now",
               "datetime.datetime.utcnow")


class NoWallClockRule(Rule):
    id = "no-wall-clock"
    doc = ("deterministic-fabric modules (cluster, msg, mon, osd) "
           "must take time as a tick parameter, not read the wall")

    def check(self, ctx: AnalysisContext) -> Iterator[Violation]:
        if not _path_allowed(ctx.relpath, WALL_CLOCK_SCOPE):
            return
        if _path_allowed(ctx.relpath, WALL_CLOCK_ALLOWED):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dn = ctx.resolve_call(node.func)
            if dn in _WALL_READS:
                yield Violation(
                    self.id, ctx.path, node.lineno,
                    f"{dn}() is a wall read inside the deterministic "
                    f"fabric — take `now` from the tick, or pragma the "
                    f"site with its justification")


# ---------------------------------------------------------------------------
# no-wire-drift
# ---------------------------------------------------------------------------

WIRE_MODULE = "msg/messages.py"


def collect_wire_fields(tree: ast.Module) -> Dict[str, List[str]]:
    """Per Message-subclass sorted field list, from the dataclass
    class bodies (AnnAssign + plain class-level Assign)."""
    bases: Dict[str, List[str]] = {}
    class_nodes: Dict[str, ast.ClassDef] = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            class_nodes[node.name] = node
            bases[node.name] = [_dotted(b) for b in node.bases]

    def is_message(name: str, seen: Optional[Set[str]] = None) -> bool:
        if name == "Message":
            return True
        seen = seen or set()
        if name in seen or name not in bases:
            return False
        seen.add(name)
        return any(is_message(b, seen) for b in bases[name])

    out: Dict[str, List[str]] = {}
    for name, node in class_nodes.items():
        if not is_message(name):
            continue
        fields = []
        for stmt in node.body:
            if isinstance(stmt, ast.AnnAssign) and \
                    isinstance(stmt.target, ast.Name):
                fields.append(stmt.target.id)
            elif isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and not \
                            t.id.isupper():  # class constants aren't wire
                        fields.append(t.id)
        out[name] = sorted(fields)
    return out


def load_wire_manifest() -> Dict[str, List[str]]:
    with open(WIRE_MANIFEST_PATH, "r", encoding="utf-8") as f:
        return json.load(f)


class NoWireDriftRule(Rule):
    id = "no-wire-drift"
    doc = ("Message subclass field lists are pinned against "
           "analysis/wire_manifest.json — a new/renamed wire field "
           "fails lint before it can drift the pinned corpus")

    def check(self, ctx: AnalysisContext) -> Iterator[Violation]:
        if ctx.relpath.replace(os.sep, "/") != WIRE_MODULE:
            return
        try:
            manifest = load_wire_manifest()
        except FileNotFoundError:
            yield Violation(self.id, ctx.path, 1,
                            f"wire manifest missing: {WIRE_MANIFEST_PATH}"
                            " (run --update-wire-manifest once)")
            return
        current = collect_wire_fields(ctx.tree)
        lineno = {n.name: n.lineno for n in ctx.tree.body
                  if isinstance(n, ast.ClassDef)}
        for cls, fields in sorted(current.items()):
            if cls not in manifest:
                yield Violation(
                    self.id, ctx.path, lineno.get(cls, 1),
                    f"new wire message {cls!r} not in the pinned "
                    f"manifest — extend the encoding corpus, then "
                    f"`python -m ceph_tpu_torch.analysis "
                    f"--update-wire-manifest`")
                continue
            added = sorted(set(fields) - set(manifest[cls]))
            removed = sorted(set(manifest[cls]) - set(fields))
            for f in added:
                yield Violation(
                    self.id, ctx.path, lineno.get(cls, 1),
                    f"wire field {cls}.{f} is not in the pinned "
                    f"manifest — wire drift; re-validate the corpus "
                    f"and update the manifest deliberately")
            for f in removed:
                yield Violation(
                    self.id, ctx.path, lineno.get(cls, 1),
                    f"pinned wire field {cls}.{f} disappeared — "
                    f"removing a wire field breaks the pinned corpus")
        for cls in sorted(set(manifest) - set(current)):
            yield Violation(
                self.id, ctx.path, 1,
                f"pinned wire message {cls!r} disappeared from "
                f"msg/messages.py")


# ---------------------------------------------------------------------------
# jit-cache-hygiene
# ---------------------------------------------------------------------------

# the port's compile and capture points: each builds something costly
# (a compiled graph, a captured CUDA graph, a loaded kernel library)
# that must be built once, not per call
_CAPTURE_CALLS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.cuda.CUDAGraph", "torch.cuda.graph", "ctypes.CDLL")
# names of functions recognized as build-once plan constructors
_PLAN_FN_RE = re.compile(r"(__init__|_jit\b|_jit$|build|plan|cached)")


def _module_names(tree: ast.Module) -> Set[str]:
    """Names bound by an assignment at module level."""
    out = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


class JitCacheHygieneRule(Rule):
    id = "jit-cache-hygiene"
    doc = ("torch.compile/torch.jit/CUDA-graph capture and ctypes "
           "kernel-library loads must be module-level, inside recognized "
           "cached-plan constructors, or memoized (no per-call rebuilds)")

    def check(self, ctx: AnalysisContext) -> Iterator[Violation]:
        if not ({"torch", "ctypes"} & ctx.imported_modules()):
            return
        viol: List[Violation] = []
        caches = _module_names(ctx.tree)

        def fn_allowed(stack: List[str]) -> bool:
            # module/class level, or an enclosing fn a plan constructor
            funcs = [s for s in stack if s]
            return not funcs or any(_PLAN_FN_RE.search(f) for f in funcs)

        def memo_target(t) -> bool:
            # `self._fn = ...` or `_cache[key] = ...` into a module-level
            # cache
            if isinstance(t, ast.Attribute):
                return isinstance(t.value, ast.Name) and t.value.id == "self"
            return isinstance(t, ast.Subscript) and \
                isinstance(t.value, ast.Name) and t.value.id in caches

        class V(ast.NodeVisitor):
            def __init__(self):
                self.fstack: List[str] = []
                self.memo_depth = 0

            def _visit_fn(self, node):
                for d in node.decorator_list:
                    self._check_decorator(d, node)
                self.fstack.append(node.name)
                for child in (node.body
                              + getattr(node.args, "defaults", [])):
                    self.visit(child)
                self.fstack.pop()

            visit_FunctionDef = _visit_fn
            visit_AsyncFunctionDef = _visit_fn

            def visit_ClassDef(self, node):
                for d in node.decorator_list:
                    self.visit(d)
                self.fstack.append("")          # class scope marker
                for child in node.body:
                    self.visit(child)
                self.fstack.pop()

            def _check_decorator(self, dec, fn_node):
                # @torch.compile / @torch.jit.script /
                # @functools.partial(torch.compile, ...)
                exprs = [dec]
                if isinstance(dec, ast.Call):
                    exprs += [dec.func] + list(dec.args)
                if any(ctx.resolve_call(e) in _CAPTURE_CALLS
                       for e in exprs) and not fn_allowed(self.fstack):
                    viol.append(Violation(
                        JitCacheHygieneRule.id, ctx.path, dec.lineno,
                        f"compile/capture decorator on {fn_node.name!r} "
                        f"inside a non-constructor function rebuilds per "
                        f"call — hoist it or memoize the built fn"))

            def visit_Assign(self, node):
                # memoized-plan idiom: `self._fn = torch.compile(...)`,
                # `lib = _libs[name] = ctypes.CDLL(...)`: build-once by
                # construction
                memo = any(memo_target(t) for t in node.targets)
                if memo:
                    self.memo_depth += 1
                self.generic_visit(node)
                if memo:
                    self.memo_depth -= 1

            def visit_Call(self, node):
                name = ctx.resolve_call(node.func)
                if name in _CAPTURE_CALLS and \
                        not fn_allowed(self.fstack) and not self.memo_depth:
                    viol.append(Violation(
                        JitCacheHygieneRule.id, ctx.path, node.lineno,
                        f"{name}() inside "
                        f"{'.'.join(s for s in self.fstack if s)}() "
                        f"is not a recognized cached-plan constructor — "
                        f"each call rebuilds; hoist to __init__/module "
                        f"level or memoize it"))
                self.generic_visit(node)

        V().visit(ctx.tree)
        yield from viol


# ---------------------------------------------------------------------------
# options-doc-coverage
# ---------------------------------------------------------------------------

# ONE-TIME allowlist of options that predate this lint and are not yet
# documented under docs/.  This list is CLOSED: entries may only be
# removed (by documenting the option) — a new option landing here
# instead of in docs/ is a lint failure by design.
OPTIONS_DOC_ALLOW: Set[str] = set()


class OptionsDocCoverageRule(Rule):
    id = "options-doc-coverage"
    doc = ("every option registered in common/config.py must be "
           "documented under docs/ (one-time closed allowlist for "
           "pre-existing gaps)")

    def _docs_text(self) -> str:
        docs_dir = os.path.join(REPO_ROOT, "docs")
        chunks = []
        if os.path.isdir(docs_dir):
            for f in sorted(os.listdir(docs_dir)):
                if f.endswith(".md"):
                    with open(os.path.join(docs_dir, f),
                              encoding="utf-8") as fh:
                        chunks.append(fh.read())
        return "\n".join(chunks)

    def check(self, ctx: AnalysisContext) -> Iterator[Violation]:
        if ctx.relpath.replace(os.sep, "/") != "common/config.py":
            return
        docs = self._docs_text()
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and _call_name(node) == "Option" and node.args):
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue  # f-string families (debug_<subsys>) are
                # documented as a family; runtime coverage is in tests
            name = arg.value
            if name in OPTIONS_DOC_ALLOW:
                continue
            if name not in docs:
                yield Violation(
                    self.id, ctx.path, node.lineno,
                    f"option {name!r} is not documented anywhere "
                    f"under docs/ — an option an operator cannot "
                    f"discover is an option nobody sets")


ALL_RULES = [NoBareLockRule, NoUntrackedSyncRule, NoWallClockRule,
             NoWireDriftRule, JitCacheHygieneRule,
             OptionsDocCoverageRule]


def rule_by_id(rule_id: str) -> Rule:
    for cls in ALL_RULES:
        if cls.id == rule_id:
            return cls()
    raise KeyError(f"unknown rule {rule_id!r}; known: "
                   f"{[c.id for c in ALL_RULES]}")
