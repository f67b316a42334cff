"""The SASS instruction mix of CUDA kernels, as compiled for Hopper.

    python -m art_tpu_torch.sass_mix SOURCE.cu [SOURCE.cu ...]

Compiles each source with the package's own nvcc flags (``kernels.py``)
into a cubin, disassembles it with ``cuobjdump -sass`` and prints, for
each kernel, its static instruction count by class: shared-memory loads
(LDS), constant-bank loads (LDC), special-function unit (MUFU), float32
arithmetic (FP32: FADD, FMUL, FFMA, FMNMX, FSETP, FSEL, FSET, FCHK) and
all instructions but NOP. These are counts of the code, not of the
instructions a run issues: a loop or a rarely taken branch (the slow
paths of IEEE division and square root) counts once. Needs nvcc and
cuobjdump (the CUDA toolkit), so it runs where the kernels are built.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

from art_tpu_torch import kernels

FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK"}
_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")


def _tool(name):
    found = shutil.which(name)
    if found:
        return found
    cand = Path(kernels._nvcc()).parent / name
    if cand.is_file():
        return str(cand)
    raise RuntimeError(f"{name} not found beside nvcc")


def opcode_counts(sass):
    """cuobjdump -sass text -> {kernel: Counter of base opcodes}."""
    out, cur = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return out


def mix(counts):
    """Counter of opcodes -> the classes this module reports."""
    return {"LDS": counts["LDS"], "LDC": counts["LDC"],
            "MUFU": counts["MUFU"],
            "FP32": sum(counts[k] for k in FP32),
            "total": sum(v for k, v in counts.items() if k != "NOP")}


def source_mix(src):
    """{kernel (demangled where cu++filt is found): mix} of one .cu."""
    flags = [f for f in kernels.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        subprocess.run([kernels._nvcc(), *flags, "-cubin", "-o", str(cubin),
                        str(src)], check=True, capture_output=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              check=True, capture_output=True,
                              text=True).stdout
    found = opcode_counts(sass)
    names = list(found)
    try:
        names = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                               check=True, capture_output=True,
                               text=True).stdout.splitlines()
    except (RuntimeError, subprocess.CalledProcessError):
        pass
    return {n: mix(c) for n, c in zip(names, found.values())}


def main(argv):
    if not argv:
        raise SystemExit(__doc__)
    for src in argv:
        for name, m in source_mix(src).items():
            print(f"{src}: {name}: " + ", ".join(
                f"{k} {v}" for k, v in m.items()), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
