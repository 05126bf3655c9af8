#!/usr/bin/env python
"""Extract format-constant data tables from the reference implementation.

The UASTC/BC7/ASTC/ETC bit-format constants (mode LUTs, common-partition
pattern tables, anchor tables, integer-sequence-encoding LUTs, modifier
tables) are fixed by the Basis Universal / GPU texture format specs; every
implementation must embed numerically identical copies.  We pull them out of
the reference sources (/root/reference/src/*.rs) once, as *data*, and emit a
generated Python module so the numbers can't be mistyped.

Run:  python tools/extract_tables.py
Writes: basisu_rs_jax/tables/generated_tables.py
"""

import re
import sys
from pathlib import Path

REF = Path("/root/reference/src")
OUT = Path(__file__).resolve().parent.parent / "basisu_rs_jax" / "tables" / "generated_tables.py"


def read(relpath: str) -> str:
    return (REF / relpath).read_text()


def find_array_body(src: str, name: str) -> str:
    """Return the literal body of `static NAME: ... = [ ... ];` (balanced)."""
    m = re.search(rf"(?:static|const)\s+{name}\s*:[^=]+=\s*\[", src)
    if not m:
        raise KeyError(name)
    start = m.end()  # position right after the opening '['
    depth = 1
    i = start
    while depth > 0:
        c = src[i]
        if c == "[":
            depth += 1
        elif c == "]":
            depth -= 1
        i += 1
    return src[start : i - 1]


def ints_of(body: str) -> list[int]:
    body = re.sub(r"//.*", "", body)
    body = body.replace("true", "1").replace("false", "0")
    toks = re.findall(r"-?(?:0x[0-9A-Fa-f_]+|\d+)", body)
    out = []
    for t in toks:
        t = t.replace("_", "")
        out.append(int(t, 16) if t.startswith(("0x", "-0x")) else int(t))
    return out


def grid(vals: list[int], cols: int) -> list[list[int]]:
    assert len(vals) % cols == 0, (len(vals), cols)
    return [vals[i : i + cols] for i in range(0, len(vals), cols)]


def emit(f, pyname: str, vals, comment: str):
    f.write(f"# {comment}\n{pyname} = {vals!r}\n\n")


def main() -> None:
    uastc = read("uastc.rs")
    astc = read("target_formats/astc.rs")
    bc7 = read("target_formats/bc7.rs")
    etc = read("target_formats/etc.rs")

    specs = [
        # (rust_file_src, rust_name, py_name, cols or None, source comment)
        (uastc, "MODE_LUT", "MODE_LUT", None, "uastc.rs:560 (7-bit mode code -> mode table index; 19 = invalid)"),
        (uastc, "PATTERNS_2", "PATTERNS_2", 16, "uastc.rs:748 (2-subset common-partition texel assignments)"),
        (uastc, "PATTERNS_3", "PATTERNS_3", 16, "uastc.rs:768"),
        (uastc, "PATTERNS_2_3", "PATTERNS_2_3", 16, "uastc.rs:778 (mode 7: 2 subsets drawn from the 2/3 table)"),
        (uastc, "PATTERNS_2_ANCHORS", "PATTERNS_2_ANCHORS", 2, "uastc.rs:792"),
        (uastc, "PATTERNS_3_ANCHORS", "PATTERNS_3_ANCHORS", 3, "uastc.rs:801"),
        (uastc, "PATTERNS_2_3_ANCHORS", "PATTERNS_2_3_ANCHORS", 2, "uastc.rs:807"),
        (astc, "PATTERNS_2_ASTC_INDEX_10", "PATTERNS_2_ASTC_INDEX_10", None, "astc.rs:183 (10-bit ASTC partition seeds)"),
        (astc, "PATTERNS_3_ASTC_INDEX_10", "PATTERNS_3_ASTC_INDEX_10", None, "astc.rs:188"),
        (astc, "PATTERNS_2_3_ASTC_INDEX_10", "PATTERNS_2_3_ASTC_INDEX_10", None, "astc.rs:191"),
        (astc, "ASTC_QUINT_ENCODE_LUT", "ASTC_QUINT_ENCODE_LUT", None, "astc.rs:208 (q0+5*q1+25*q2 -> 7-bit ASTC quint block)"),
        (astc, "ASTC_TRIT_ENCODE_LUT", "ASTC_TRIT_ENCODE_LUT", None, "astc.rs:247 (t0+3*t1+... -> 8-bit ASTC trit block)"),
        (astc, "UASTC_TO_ASTC_BLOCK_MODE_13", "UASTC_TO_ASTC_BLOCK_MODE_13", None, "astc.rs:333"),
        (bc7, "UASTC_TO_BC7_MODES", "UASTC_TO_BC7_MODES", None, "bc7.rs:582"),
        (bc7, "PATTERNS_2_BC7_INDEX_INV", "PATTERNS_2_BC7_INDEX_INV", 2, "bc7.rs:592 ((bc7 partition index, invert) pairs)"),
        (bc7, "PATTERNS_3_BC7_INDEX_PERM", "PATTERNS_3_BC7_INDEX_PERM", 2, "bc7.rs:604 ((bc7 partition index, permutation id))"),
        (bc7, "PATTERNS_3_BC7_TO_ASTC_PERMUTATIONS", "PATTERNS_3_BC7_TO_ASTC_PERMUTATIONS", 3, "bc7.rs:611"),
        (bc7, "PATTERNS_2_3_BC7_INDEX_PERM", "PATTERNS_2_3_BC7_INDEX_PERM", 2, "bc7.rs:616"),
        (bc7, "PATTERNS_2_3_BC7_TO_ASTC_PERMUTATIONS", "PATTERNS_2_3_BC7_TO_ASTC_PERMUTATIONS", 3, "bc7.rs:625"),
        (bc7, "PATTERNS_2_BC7", "PATTERNS_2_BC7", 16, "bc7.rs:656 (BC7-order texel assignments)"),
        (bc7, "PATTERNS_3_BC7", "PATTERNS_3_BC7", 16, "bc7.rs:675"),
        (bc7, "PATTERNS_2_3_BC7", "PATTERNS_2_3_BC7", 16, "bc7.rs:685"),
        (bc7, "PATTERNS_2_BC7_ANCHORS", "PATTERNS_2_BC7_ANCHORS", 2, "bc7.rs:701 (anchor texel per subset, 64 BC7 partitions)"),
        (bc7, "PATTERNS_3_BC7_ANCHORS", "PATTERNS_3_BC7_ANCHORS", 3, "bc7.rs:713"),
        (etc, "ETC1_MODIFIERS", "ETC1_MODIFIERS", 4, "etc.rs:436 (ETC1 intensity modifier table)"),
        (etc, "ETC2_ALPHA_MODIFIERS", "ETC2_ALPHA_MODIFIERS", 8, "etc.rs:451 (EAC alpha modifier table)"),
    ]

    with OUT.open("w") as f:
        f.write(
            '"""GENERATED by tools/extract_tables.py - do not edit by hand.\n\n'
            "Format-constant tables shared by every Basis Universal implementation.\n"
            "Source of numbers: the reference implementation (see per-table citations).\n"
            '"""\n\n# fmt: off\n\n'
        )
        for src, rust_name, py_name, cols, comment in specs:
            vals = ints_of(find_array_body(src, rust_name))
            emit(f, py_name, grid(vals, cols) if cols else vals, comment)
        f.write("# fmt: on\n")

    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.exit(main())
