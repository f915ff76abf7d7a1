"""The narrow bank sweep's machine code in this checkout and in another.

    python3 prof_torch/narrow_sass.py --parent DIR

DIR is a checkout of an earlier commit (for example unpacked with ``git
archive`` into ``_parent/``). Builds ``csrc/affinity_bank.cu`` in both
checkouts (each with its own ``ops/_build.py``, in a child process), runs
``cuobjdump -sass`` on both libraries and compares the four narrow
instantiations of ``affinity_bank_kernel<kC256, kNT>`` (C 256 or less, 3 or
8 label n-tiles): whether their SASS reads the same, and whether it does
once register numbers, predicates and reuse flags are blanked (the same
instructions in the same order), with each side's instruction count. Prints
one line a function and a JSON line last; exits 1 if any instantiation's
blanked SASS differs. Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not
a card; about a minute.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NARROW = re.compile(r"affinity_bank_kernelILb([01])ELi(\d+)E")
INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
BLANK = ((re.compile(r"\bU?R(\d+|Z)\b"), "R"), (re.compile(r"\bU?P(\d|T)\b"), "P"), (re.compile(r"\.reuse\b"), ""))


def build(root: Path) -> Path:
    """Builds ``affinity_bank`` with ``root``'s own build module, in a child
    process; returns the library's path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from semi_supervised_vos_tpu_torch.ops import _build as b; "
            "b.build(['affinity_bank']); print(b.library_path('affinity_bank'))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True, check=True,
                         timeout=600)
    lib = Path(out.stdout.strip().splitlines()[-1])
    assert lib.is_relative_to(root), f"{lib} is not under {root}"
    return lib


def narrow_functions(lib: Path) -> dict:
    """{"<kC256>,<kNT>": [instruction text, ...]} of the narrow kernels."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            match = NARROW.search(line)
            name = f"{'true' if match.group(1) == '1' else 'false'},{match.group(2)}" if match else None
            if name is not None:
                funcs[name] = []
        elif name is not None:
            instr = INSTR.search(line)
            if instr:
                funcs[name].append(instr.group(1))
    return funcs


def blank(instrs: list) -> list:
    out = []
    for text in instrs:
        for pattern, repl in BLANK:
            text = pattern.sub(repl, text)
        out.append(" ".join(text.split()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    sides = {name: narrow_functions(build(root.resolve())) for name, root in (("parent", args.parent),
                                                                                ("change", ROOT))}
    rows, ok = [], True
    for fn in sorted(set(sides["parent"]) | set(sides["change"])):
        a, b = sides["parent"].get(fn, []), sides["change"].get(fn, [])
        row = dict(kernel=f"affinity_bank_kernel<{fn}>", parent_instructions=len(a), change_instructions=len(b),
                   identical=a == b, identical_blanked=blank(a) == blank(b))
        ok &= bool(a) and row["identical_blanked"]
        rows.append(row)
        print(f"{row['kernel']}: {len(a)} / {len(b)} instructions, same text {row['identical']}, "
              f"identical with registers blanked {row['identical_blanked']}", flush=True)
    print(json.dumps(dict(functions=rows, ok=ok and len(rows) == 4)))
    return 0 if ok and len(rows) == 4 else 1


if __name__ == "__main__":
    raise SystemExit(main())
