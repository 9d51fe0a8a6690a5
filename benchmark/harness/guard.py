"""The import check: the benchmark measures the PyTorch port alone.

Names are compared whole, by their top level (the part before the first
dot): ``dagr_tpu_torch`` is the program, ``dagr_tpu`` the JAX package
beside it, which nothing here may load.  ``forbidden_modules`` reads
what a process has loaded; ``scan`` reads the import statements of the
benchmark's sources, and holds the reference to import nothing of the
program either.
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "dagr_tpu")
PROGRAM = "dagr_tpu_torch"
BENCH_DIR = Path(__file__).resolve().parent.parent


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def imports_of(path: Path) -> List[str]:
    """The modules a source file imports, by their full names."""
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def scan(bench_dir: Path = BENCH_DIR) -> List[str]:
    """Offending imports under ``bench_dir``: a forbidden top-level name
    anywhere, and the program in the reference."""
    bad = []
    for path in sorted(bench_dir.rglob("*.py")):
        rel = path.relative_to(bench_dir)
        in_reference = rel.parts[0] == "reference"
        for name in imports_of(path):
            if top(name) in FORBIDDEN or (in_reference
                                          and top(name) == PROGRAM):
                bad.append(f"{rel}: {name}")
    return bad
