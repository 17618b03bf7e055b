#!/usr/bin/env python3
"""Compare the compiled code of two checkouts' kernel libraries, as
``tools/time_rel_attention.py --sass FILE`` (machine code) and ``--ptxas
FILE`` (-Xptxas -v lines) wrote it: for each library, how many kernels are
the same, differ, or are in one file only.

    python3 tools/compare_sass.py PARENT.sass CHANGE.sass [PARENT.ptxas CHANGE.ptxas]

Kernels are matched by name with the per-file namespace hash taken out.  B7's
head-0 kernel of earlier checkouts (``rel_head0_consume_kernel<QD, T>``) is
matched with the one-head case of the wide consume kernel that replaced it
(``rel_wide_consume_kernel<QD, T, T, false>``).  Instruction addresses and
column padding are ignored; the instructions and their encodings are not.
Prints one line a library; exits 1 if any kernel present in both differs.
"""

from __future__ import annotations

import re
import sys
from collections import defaultdict


def canon(name: str) -> str:
    """A kernel's name without the per-file namespace hash; B7's kernel of
    either form as ("B7", QD, type)."""
    b7 = re.search(r"rel_head0_consume_kernelILi(\d+)E(f|13__nv_bfloat16)E", name) or (
        "Lb0E" in name
        and re.search(r"rel_wide_consume_kernelILi(\d+)E(f|13__nv_bfloat16)", name))
    if b7:
        return f"B7 QD={b7.group(1)} {b7.group(2)}"
    return re.sub(r"_cu_[0-9a-f]{8}", "_cu_", re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", name))


def sass_kernels(path: str):
    """{library: {kernel: [instruction lines]}} of a --sass file."""
    out: dict = defaultdict(dict)
    current = {}
    for raw in open(path):
        lib, _, line = raw.partition(": ")
        m = re.search(r"Function : (\S+)", line)
        if m:
            current[lib] = canon(m.group(1))
            out[lib][current[lib]] = []
        elif lib in current:
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)  # the address column
            line = " ".join(line.split())
            if line:
                out[lib][current[lib]].append(line)
    return out


def ptxas_kernels(path: str):
    """{library: {kernel: [resource lines]}} of a --ptxas file."""
    out: dict = defaultdict(lambda: defaultdict(list))
    entry = {}
    for raw in open(path):
        lib, _, line = raw.partition(": ")
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            entry[lib] = canon(m.group(1))
        elif lib in entry:
            out[lib][entry[lib]].append(" ".join(line.split()))
    return out


def compare(a: dict, b: dict, what: str) -> bool:
    ok = True
    for lib in sorted(set(a) | set(b)):
        ka, kb = a.get(lib, {}), b.get(lib, {})
        both = set(ka) & set(kb)
        differ = sorted(k for k in both if ka[k] != kb[k])
        only = len(set(ka) ^ set(kb))
        print(f"{what} {lib}: {len(ka)} / {len(kb)} kernels, {len(both) - len(differ)} the "
              f"same, {len(differ)} differ, {only} in one file only", flush=True)
        for k in differ[:3]:
            print(f"    differs: {k[:150]}")
        ok = ok and not differ
    return ok


def main() -> int:
    args = sys.argv[1:]
    if len(args) not in (2, 4):
        print(__doc__, file=sys.stderr)
        return 2
    ok = compare(sass_kernels(args[0]), sass_kernels(args[1]), "SASS")
    if len(args) == 4:
        ok = compare(ptxas_kernels(args[2]), ptxas_kernels(args[3]), "ptxas") and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
