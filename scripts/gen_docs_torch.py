#!/usr/bin/env python
"""Write (or verify) the PyTorch port's generated reference docs.

    PYTHONPATH=src python scripts/gen_docs_torch.py           # regenerate in place
    PYTHONPATH=src python scripts/gen_docs_torch.py --check   # fail on drift

The content comes from :mod:`repro_torch.explorer.docgen`, which walks the
port's spec dataclasses' validation metadata, its component registries
and the ``repro_torch.envvars.ENV_VARS`` registry, into
``docs/reference/torch/*.md`` (the JAX package's ``docs/reference/*.md``
are ``scripts/gen_docs.py``'s).  ``--check`` renders into memory and
diffs against the committed files, so a change to the port's YAML
surface, a registry or an env knob that was not regenerated fails.
"""
from __future__ import annotations

import argparse
import difflib
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO_ROOT, "src"))

from repro_torch.explorer.docgen import generated_files  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--check", action="store_true",
                   help="verify the committed files match the generated "
                        "output instead of writing (exit 1 on drift)")
    args = p.parse_args(argv)

    files = generated_files()
    drifted = []
    for rel_path, content in files.items():
        path = os.path.join(REPO_ROOT, rel_path)
        if args.check:
            try:
                with open(path) as f:
                    committed = f.read()
            except OSError:
                committed = ""
            if committed != content:
                drifted.append(rel_path)
                sys.stderr.writelines(difflib.unified_diff(
                    committed.splitlines(keepends=True),
                    content.splitlines(keepends=True),
                    fromfile=f"{rel_path} (committed)",
                    tofile=f"{rel_path} (generated)"))
        else:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(content)
            print(f"wrote {rel_path}")

    if drifted:
        print(f"\nthe port's reference docs drifted from the code: {drifted}\n"
              f"regenerate with: PYTHONPATH=src python scripts/gen_docs_torch.py",
              file=sys.stderr)
        return 1
    if args.check:
        print(f"docs in sync ({len(files)} files)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
