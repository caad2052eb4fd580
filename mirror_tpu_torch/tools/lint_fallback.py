"""Stdlib lint gate of the port, for a machine without ruff or mypy.

Counterpart of ``mirror_tpu/tools/lint_fallback.py``, with its checks, per
Python file: syntax (``ast.parse``), unused imports, and a ``print`` in
library code (``mirror_tpu_torch/`` but its ``tools/`` and ``scripts/``
CLIs: library modules log through ``logging``; a line marked
``# lint: allow-print`` is a stdout contract). By default it walks
``mirror_tpu_torch/``, ``chip_smoke.py`` and ``tests/test_torch_*.py``:

    python -m mirror_tpu_torch.tools.lint_fallback [paths...]

Exits 1 when it finds a problem.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

PACKAGE = "mirror_tpu_torch"
CLI_DIRS = ("tools", "scripts")


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield (a.asname or a.name.split(".")[0]), node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            for a in node.names:
                if a.name == "*":
                    continue
                yield (a.asname or a.name), node.lineno


def _used_names(tree: ast.AST):
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            base = node
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name):
                used.add(base.id)
    return used


def in_library(path: Path) -> bool:
    """Library code: under the package, outside its CLI directories."""
    parts = path.parts
    if PACKAGE not in parts:
        return False
    inside = parts[parts.index(PACKAGE) + 1:]
    return not any(d in inside[:-1] for d in CLI_DIRS)


def check_file(path: Path) -> list[str]:
    src = path.read_text()
    problems = []
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: syntax error: {e.msg}"]

    is_init = path.name == "__init__.py"
    has_all = any(
        isinstance(n, ast.Assign)
        and any(isinstance(t, ast.Name) and t.id == "__all__" for t in n.targets)
        for n in tree.body
    )
    used = _used_names(tree)
    # names re-exported via __all__ strings count as used
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.add(node.value)
    lines = src.splitlines()
    if not (is_init or has_all):
        for name, lineno in _imported_names(tree):
            line = lines[lineno - 1] if lineno <= len(lines) else ""
            # "noqa: F401": an import kept for its side effect (a fixture, op registration)
            if name not in used and name != "_" and "noqa: F401" not in line:
                problems.append(f"{path}:{lineno}: unused import '{name}'")

    if in_library(path):
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"
            ):
                line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
                if "lint: allow-print" in line:
                    continue  # deliberate stdout contract (e.g. --result)
                problems.append(
                    f"{path}:{node.lineno}: print() in library code "
                    "(use logging, or mark '# lint: allow-print')"
                )
    return problems


def main(argv: list[str]) -> int:
    repo = Path(__file__).resolve().parents[2]
    targets = [Path(a) for a in argv] or [
        repo / PACKAGE,
        repo / "chip_smoke.py",
        *sorted((repo / "tests").glob("test_torch_*.py")),
    ]
    files: list[Path] = []
    for t in targets:
        files.extend(t.rglob("*.py") if t.is_dir() else [t])
    problems = []
    for f in sorted(set(files)):
        problems.extend(check_file(f))
    for p in problems:
        print(p)
    print(f"lint_fallback: {len(files)} files, {len(problems)} problems")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
