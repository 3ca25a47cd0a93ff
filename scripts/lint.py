"""Minimal lint gate (the image ships no ruff/flake8/black).

Analog of the reference CI's ``cargo fmt --check`` + ``clippy -D warnings``
(``/root/reference/ci/check.sh``): every finding is an error.  Checks:

- unused imports (AST-based, per module; ``# noqa`` on the import line opts out)
- syntax errors (via ast.parse)
- style: tabs in indentation, trailing whitespace, missing EOF newline,
  CRLF line endings

The C++ side's ``-D warnings`` analog is ``-Wall -Wextra -Werror`` in
``native/Makefile``.
"""

import ast
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TARGETS = ["fqtk_tpu", "tests", "scripts", "bench.py", "chip_smoke.py", "__graft_entry__.py"]


def _py_files():
    for t in TARGETS:
        p = REPO / t
        if p.is_file():
            yield p
        else:
            yield from sorted(p.rglob("*.py"))


class ImportCollector(ast.NodeVisitor):
    def __init__(self):
        self.imports = {}  # name -> (lineno, stmt)

    def visit_Import(self, node):
        for a in node.names:
            name = (a.asname or a.name).split(".")[0]
            self.imports[name] = node.lineno

    def visit_ImportFrom(self, node):
        if node.module == "__future__":
            return  # compiler directives, not names
        for a in node.names:
            if a.name == "*":
                continue
            self.imports[a.asname or a.name] = node.lineno


def check_file(path: Path):
    errors = []
    raw = path.read_bytes()
    text = raw.decode("utf-8", "replace")
    if b"\r\n" in raw:
        errors.append(f"{path}: CRLF line endings")
    if raw and not raw.endswith(b"\n"):
        errors.append(f"{path}: missing newline at EOF")
    noqa_lines = set()
    for i, line in enumerate(text.splitlines(), 1):
        if line != line.rstrip():
            errors.append(f"{path}:{i}: trailing whitespace")
        if line.startswith("\t"):
            errors.append(f"{path}:{i}: tab indentation")
        if "# noqa" in line:
            noqa_lines.add(i)
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError as e:
        errors.append(f"{path}:{e.lineno}: syntax error: {e.msg}")
        return errors
    col = ImportCollector()
    col.visit(tree)
    if col.imports:
        used = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                pass  # attribute roots are Names, already collected
        # names re-exported via __all__ count as used
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Assign)
                and any(
                    isinstance(t, ast.Name) and t.id == "__all__"
                    for t in node.targets
                )
                and isinstance(node.value, (ast.List, ast.Tuple))
            ):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                        used.add(elt.value)
        for name, lineno in sorted(col.imports.items()):
            if name in used or name == "_" or lineno in noqa_lines:
                continue
            errors.append(f"{path}:{lineno}: unused import '{name}'")
    return errors


def main() -> int:
    all_errors = []
    n = 0
    for f in _py_files():
        n += 1
        all_errors += check_file(f)
    if all_errors:
        print("\n".join(all_errors))
        print(f"\nlint: {len(all_errors)} error(s) in {n} files")
        return 1
    print(f"lint: {n} files clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
