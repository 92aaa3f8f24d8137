"""Repo discovery + the zipnn-lint CLI (``python -m repro_torch.analysis``)."""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, List, Optional, Sequence

from .base import Project, SourceFile, Violation, analyze_project, default_families

# Trees scanned for analysis.  Rule families narrow further by prefix; the
# project still loads all of src/repro_torch so cross-file rules see everything.
SCAN_PREFIX = os.path.join("src", "repro_torch")


def find_repo_root(start: Optional[str] = None) -> str:
    """Repo root = the directory holding ``src/repro_torch`` for this package."""
    here = start or os.path.dirname(os.path.abspath(__file__))
    cur = here
    for _ in range(8):
        if os.path.isdir(os.path.join(cur, "src", "repro_torch")):
            return cur
        nxt = os.path.dirname(cur)
        if nxt == cur:
            break
        cur = nxt
    raise SystemExit("zipnn-lint: cannot locate repo root (src/repro_torch)")


def load_project(root: str) -> Project:
    files: List[SourceFile] = []
    extra: Dict[str, str] = {}
    scan_dir = os.path.join(root, SCAN_PREFIX)
    for dirpath, dirnames, filenames in os.walk(scan_dir):
        dirnames.sort()
        for fname in sorted(filenames):
            if not fname.endswith((".py", ".cu")):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
            if fname.endswith(".cu"):
                extra[rel] = text
                continue
            try:
                files.append(SourceFile.parse(rel, text))
            except SyntaxError as e:
                raise SystemExit(f"zipnn-lint: cannot parse {rel}: {e}")
    return Project(files, extra)


def run_repo(root: Optional[str] = None) -> List[Violation]:
    root = root or find_repo_root()
    return analyze_project(load_project(root))


def _emit_github(v: Violation) -> str:
    # GitHub Actions annotation: clickable in the PR "Files changed" view.
    msg = v.message.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")
    return f"::error file={v.path},line={v.line},title=zipnn-lint {v.rule}::{msg}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="zipnn-lint: static checks for the ZipNN repo invariants "
        "(determinism, knob threading, container spec, kernel contracts). "
        "See docs/INVARIANTS.md.",
    )
    ap.add_argument(
        "--root", default=None, help="repo root (default: auto-detected)"
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="CI mode: exit 1 on any finding, including bad suppressions "
        "(currently identical to the default — reserved so the gate can "
        "stay strict if advisory rules are added)",
    )
    ap.add_argument(
        "--github",
        action="store_true",
        help="also emit GitHub Actions ::error annotations "
        "(auto-enabled when GITHUB_ACTIONS is set)",
    )
    args = ap.parse_args(argv)

    project = load_project(args.root or find_repo_root())
    violations = analyze_project(project)
    github = args.github or bool(os.environ.get("GITHUB_ACTIONS"))
    for v in violations:
        print(v.render())
        if github:
            print(_emit_github(v))
    n_files = len(project.files)
    if violations:
        print(f"zipnn-lint: {len(violations)} violation(s)")
        return 1
    print(f"zipnn-lint: clean ({n_files} files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
