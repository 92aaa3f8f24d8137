"""zipnn-lint: repo-specific static analysis for the ZipNN reproduction.

The test suite can only *sample* the repo's central invariant — compressed
blobs byte-identical across ``backend`` x ``entropy_backend`` x ``threads``
(ROADMAP "Invariant to preserve").  This package checks, on every line of
every PR, the bug classes that would silently break it:

* :mod:`.determinism`   — nondeterminism sources on codec paths
                          (wall clocks, RNGs, set/fs iteration order,
                          ``id()`` keys, float-derived byte sizes).
* :mod:`.knobs`         — ``backend`` / ``entropy_backend`` / ``threads``
                          kwargs forwarded end-to-end from the public
                          compression surface down to the engine, with no
                          call edge dropping or re-defaulting them.
* :mod:`.container_spec`— the ZNN1/ZNS1 wire layouts declared once as
                          field tables, cross-checked against every
                          ``struct`` format string, plus bounds checks
                          before length-driven allocations at parse sites.
* :mod:`.kernel_contract`— Pallas kernel contracts: arity, ``index_map``
                          vs grid rank, block coverage, declared dtypes.

Pure stdlib (``ast``) — importing this package must never pull in jax or
numpy, so the lint CI job runs on a bare Python.

Suppressions: ``# zipnn: allow(<rule>): <reason>`` on the flagged line or
the line above.  The reason is mandatory.  See docs/INVARIANTS.md.
"""

from __future__ import annotations

from .base import Project, SourceFile, Violation, analyze_project, analyze_source
from .driver import find_repo_root, run_repo

__all__ = [
    "Project",
    "SourceFile",
    "Violation",
    "analyze_project",
    "analyze_source",
    "find_repo_root",
    "run_repo",
]
