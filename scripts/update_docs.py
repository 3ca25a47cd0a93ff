"""README CLI-reference drift gate.

Analog of the reference's ``.github/scripts/update-docs.sh`` (CI regenerates
the README usage section from ``--help`` and fails on drift,
``build_and_test.yml:36-57``).  Renders both subcommands' argparse help into
the README between the ``CLI HELP`` markers.

Usage:
    python scripts/update_docs.py           # rewrite README in place
    python scripts/update_docs.py --check   # exit 1 on drift (CI mode)
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BEGIN = "<!-- BEGIN GENERATED CLI HELP (scripts/update_docs.py) -->"
END = "<!-- END GENERATED CLI HELP -->"


def render_help() -> str:
    import os

    os.environ["COLUMNS"] = "80"  # argparse wraps at terminal width
    sys.path.insert(0, str(REPO))
    from fqtk_tpu.cli import _build_parser as build_parser

    parser = build_parser()
    sub_actions = [
        a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction"
    ]
    blocks = []
    for name in ("demux", "subsample", "concat-shards"):
        sp = sub_actions[0].choices[name]
        sp.prog = f"fqtk-tpu {name}"
        blocks.append(f"### `fqtk-tpu {name} --help`\n\n```\n{sp.format_help()}```")
    return "\n\n".join(blocks)


def main() -> int:
    check = "--check" in sys.argv
    readme = REPO / "README.md"
    text = readme.read_text()
    if BEGIN not in text or END not in text:
        print(f"README is missing the {BEGIN} / {END} markers", file=sys.stderr)
        return 1
    head, rest = text.split(BEGIN, 1)
    _, tail = rest.split(END, 1)
    new = f"{head}{BEGIN}\n\n{render_help()}\n\n{END}{tail}"
    if new == text:
        print("README CLI help is up to date")
        return 0
    if check:
        print(
            "README CLI help has drifted from --help output; run "
            "`python scripts/update_docs.py`",
            file=sys.stderr,
        )
        return 1
    readme.write_text(new)
    print("README CLI help regenerated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
