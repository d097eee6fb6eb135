"""Count the machine instructions of kernel 2's row-march, by class, on the card's machine.

    python3 scripts/torch_sass_mix.py [out_dir]

For each row below (a program, a grid and a fused depth, at the planner's
plan) it builds the kernel for `sm_90a` from this checkout, disassembles
it with `cuobjdump -sass` and counts the instructions of the whole kernel
by opcode class: shared-memory loads and stores, async copies, global
loads and stores, float arithmetic, integer and address arithmetic,
predicates and selects, barriers, branches.  The count is static (each
instruction once), and the generated march is unrolled within a step, so
the count over (RB rows x the stage copies) approximates the instructions
one thread issues per cell it computes.  Each disassembly is written to
`out_dir` (default `build/sass/`).  Needs `nvcc` and `cuobjdump` (the CUDA
toolkit), no card.
"""

from __future__ import annotations

import collections
import pathlib
import re
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
ROWS = (("blur", (2048, 4096), 1), ("blur", (16384, 16384), 1),
        ("conv5x5", (16384, 16384), 1), ("jacobi2d", (2048, 2048), 4),
        ("jacobi2d", (16384, 16384), 4), ("jacobi2d", (16384, 16384), 8))
CLASSES = (
    ("LDS", r"^LDS"), ("STS", r"^STS"), ("LDGSTS", r"^LDGSTS|^LDGDEPBAR|^DEPBAR"),
    ("LDG/STG", r"^LDG|^STG|^LD\.|^ST\."), ("float", r"^F(ADD|MUL|FMA|SETP|SEL|MNMX)|^MUFU"),
    ("f64", r"^D(ADD|MUL|FMA|SETP)"),
    ("move", r"^IMAD\.MOV|^MOV|^S2R|^S2UR|^CS2R|^ULDC|^UMOV|^R2UR|^UIADD|^ULOP|^USHF|^UISETP|^ULEA|^UIMAD|^USEL"),
    ("int", r"^I(MAD|ADD|ABS|MNMX)|^LEA|^SHF|^LOP|^IMUL|^SGXT|^BMSK|^POPC|^FLO"),
    ("predicate/select", r"^ISETP|^PLOP|^SEL|^P2R|^R2P|^FSEL|^VOTE"),
    ("barrier", r"^BAR|^WARPSYNC|^MEMBAR"),
    ("branch", r"^BRA|^BSSY|^BSYNC|^EXIT|^RET|^CALL|^BREAK|^JMP"),
)
OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def classify(op: str) -> str:
    for name, pattern in CLASSES:
        if re.match(pattern, op):
            return name
    return "other"


def main(out_dir: str = "") -> int:
    sys.path.insert(0, str(HERE))
    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.frontend.parser import parse_file
    from soda_tpu_torch.plan.planner import plan

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        print("torch_sass_mix: no cuobjdump", file=sys.stderr)
        return 2
    for n, shape, nf in ROWS:
        p = parse_file(HERE / "tests" / "soda" / f"{n}.soda")
        g = plan(p, shape, sweeps=nf).groups[0]
        built = cuda.group_kernel(p, g).build()
        sass = subprocess.run([tool, "-sass", str(built.path)], capture_output=True,
                              text=True, check=True).stdout
        out = pathlib.Path(out_dir) if out_dir else HERE / "build" / "sass"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{built.path.stem}.sass").write_text(sass)
        ops = collections.Counter(classify(m.group(1)) for m in OP.finditer(sass))
        total = sum(ops.values())
        cells = g.tile[0] * len(g.stages)
        mix = ", ".join(f"{k} {ops[k]} ({ops[k] / cells:.2f})"
                        for k, _ in CLASSES + (("other", ""),) if ops[k])
        print(f"sass {n} {shape} nf {g.sweeps}: {total} instructions, "
              f"{total / cells:.2f} per row-stage (RB {g.tile[0]} x {len(g.stages)} "
              f"stage(s)); {mix}; {g.describe()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:2]))
