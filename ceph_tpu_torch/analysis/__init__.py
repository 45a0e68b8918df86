"""Repo-wide invariant analyzer (the port's ``src/common/lockdep.cc`` +
clang-tidy role).

Port of ``ceph_tpu/analysis/``: the same rule ids, pragmas, allowlists
and CLI, walking ``ceph_tpu_torch/``.  The rules that name device calls
name torch's (``torch.cuda.synchronize``, ``.item()``/``.cpu()``,
``torch.compile``, CUDA-graph capture, kernel-library loads) where the
reference names JAX's; the wire manifest is the reference's own, so the
port's messages are held to the reference's wire format.

The reference ships race/correctness tooling as first-class
infrastructure: lockdep is wired into every qa/vstart run and the
sanitizers are CMake options.  Our port's cross-cutting contracts —
zero hidden device syncs, pinned wire format, bounded jit caches,
tick-driven fabric clocks, every lock witnessed — were until now
enforced only where some runtime test happened to sample them.  This
package checks them *statically over the whole tree* on every tier-1
round:

- :mod:`.core` — AST walk + rule registry + ``# lint: allow[...]``
  pragma mechanism;
- :mod:`.rules` — the rule catalog (no-bare-lock, no-untracked-sync,
  no-wall-clock, no-wire-drift, jit-cache-hygiene,
  options-doc-coverage) and the one-time allowlists;
- ``python -m ceph_tpu_torch.analysis`` — the runner (``--rule``,
  ``--json``, ``--changed``, path filters).

See docs/ANALYSIS.md for the catalog and the allowlist/pragma policy.
"""
from .core import AnalysisContext, Rule, Violation, iter_tree, run_analysis
from .rules import ALL_RULES, rule_by_id

__all__ = [
    "ALL_RULES", "AnalysisContext", "Rule", "Violation",
    "iter_tree", "rule_by_id", "run_analysis",
]
