"""Count the machine instructions of the marches (kernels 1 and 2), by class, on the card's machine.

    python3 scripts/torch_sass_mix.py [out_dir] [root] [program,program,...]

For each row below (a program, `+tcse` where it is rewritten by
`optimize/tcse.py` first, a grid and a fused depth, at the planner's
plan) it builds the kernel for `sm_90a` from the `soda_tpu_torch` under
`root` (default this checkout; a parent commit unpacked with `git
archive` gives the count before a change), disassembles it with
`cuobjdump -sass` and counts the instructions of the whole kernel by
opcode class: shared-memory loads and stores, async copies, global loads
and stores, float arithmetic, integer and address arithmetic, predicates
and selects, barriers, branches.  The count is static (each instruction
once).  Kernel 2's march is unrolled within a step, so the count over (RB
rows x the stage copies) approximates the instructions one thread issues
per cell it computes; kernel 1's step computes each stage in column runs
(a run's rows, from the source's "runs of N row(s)"), so the count over
the rows of one run of every stage approximates the same, with the plane
copies and the step's bookkeeping spread over them; the column z-march's
(`columns3d.py`) step computes every member at the thread's tile
columns and its share of the halo, so the count over its tile columns
approximates the same.  Where a run or a step's members are
printed twice (inside the grid without the per-cell checks, and with
them), both copies count.  A rank-2 cascade's row takes the planner's
march, or the one it names ("rings" or "columns"); the column march's
step is printed once for each of its NSLOT phases, so its count is
divided by NSLOT.  The optional third argument keeps the rows of
the programs it names.  Each disassembly is written to `out_dir`
(default `build/sass/`).  Needs `nvcc` and `cuobjdump` (the CUDA
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
        ("jacobi2d", (16384, 16384), 4), ("jacobi2d", (16384, 16384), 8),
        ("jacobi2d", (16384, 16384), 8, "rings"),
        ("gauss5x5", (16384, 16384), 1), ("gauss5x5+tcse", (16384, 16384), 1),
        ("jacobi3d", (512, 512, 512), 1), ("denoise3d", (256, 256, 256), 1),
        ("denoise3d", (512, 512, 512), 1),
        ("heat3d", (512, 512, 512), 2), ("heat3d", (512, 512, 512), 4),
        ("poisson3d_f64", (256, 256, 256), 1))
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


def main(out_dir: str = "", root: str = "", only: str = "") -> int:
    sys.path.insert(0, root or str(HERE))
    from soda_tpu_torch.backend import cuda
    from soda_tpu_torch.frontend.parser import parse_file
    from soda_tpu_torch.optimize import tcse
    from soda_tpu_torch.plan.planner import plan
    from soda_tpu_torch.utils.testing import pinned_plan

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        print("torch_sass_mix: no cuobjdump", file=sys.stderr)
        return 2
    keep = set(only.split(",")) if only else None
    for n, shape, nf, *march in ROWS:
        name, _, rewrite = n.partition("+")
        if keep and name not in keep:
            continue
        p = parse_file(HERE / "tests" / "soda" / f"{name}.soda")
        if rewrite:
            p = tcse.apply(p)
        g = (pinned_plan(p, shape, {"sweeps": nf, "march": march[0]}) if march
             else plan(p, shape, sweeps=nf)).groups[0]
        k = cuda.group_kernel(p, g)
        built = k.build()
        sass = subprocess.run([tool, "-sass", str(built.path)], capture_output=True,
                              text=True, check=True).stdout
        out = pathlib.Path(out_dir) if out_dir else HERE / "build" / "sass"
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{built.path.stem}.sass").write_text(sass)
        ops = collections.Counter(classify(m.group(1)) for m in OP.finditer(sass))
        total = sum(ops.values())
        if g.march == "columns3d":
            # a step of the column z-march: each of a thread's tile columns
            # (every member there, and its halo columns' share)
            cells = g.tile[0] * g.tile[1] // g.threads
            per = f"a step of the thread's {cells} tile columns"
            updates = cells * g.sweeps
        elif len(shape) == 3:
            # one run of every stage (the rows each prints; a block printed
            # twice, for the hazard emulation's order, counts once)
            runs = [int(r) for r in dict(re.findall(
                r"// (stage \S+|outputs \[[^]]*\]).*?runs of (\d+) row", k.source)).values()]
            cells, per = sum(runs), f"a run of each stage: {runs} rows"
            updates = sum(runs) / len(runs) * g.sweeps
        else:
            phases = int(re.search(r"NSLOT = (\d+)", k.source).group(1)) if g.march == "columns" else 1
            cells = g.tile[0] * len(g.stages) * phases
            per = f"RB {g.tile[0]} x {len(g.stages)} stage(s)" + (
                f" x {phases} phases" if phases > 1 else "")
            updates = g.tile[0] * g.sweeps * phases
        mix = ", ".join(f"{c} {ops[c]} ({ops[c] / cells:.2f})"
                        for c, _ in CLASSES + (("other", ""),) if ops[c])
        print(f"sass {n} {shape} nf {g.sweeps}: {total} instructions, "
              f"{total / cells:.2f} per row-stage ({per}), "
              f"{total / updates:.2f} per cell-update; "
              f"{mix}; "
              f"{g.describe()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
