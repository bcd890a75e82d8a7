"""Registers, spills and the SASS instruction mix of the port's CUDA kernels.

    python -m tdnet_tpu_torch.cli.sass propagation_attention_train.cu dkdv_tcILi4ELb1 dq_tc

Compiles one ``csrc`` source with the flags of ``kernels/build.py`` plus
``-Xptxas -v`` into ``build/tdnet_tpu_torch/`` (it needs ``nvcc`` and
``cuobjdump``: a machine with the CUDA toolkit) and prints, for each kernel
whose mangled name contains one of the fragments, ptxas's registers, spills
and static shared memory, its SASS instructions counted by opcode, and the
counts of the product opcodes (HMMA, HGMMA, FFMA); then ptxas's warnings (a
wgmma pipeline it serialized, a ``setmaxnreg`` it ignored).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess

from tdnet_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc

# the opcodes of a product: tensor cores (mma.sync, wgmma), CUDA-core fma
PRODUCTS = ("HMMA", "HGMMA", "FFMA")


def ptxas_info(log: str) -> dict[str, str]:
    """Mangled kernel name -> ptxas's resource lines for it, joined."""
    info: dict[str, str] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            info[name] = ""
        elif name and ("spill" in line or "Used" in line):
            info[name] += " " + line.split(":", 1)[-1].strip()
    return info


def opcode_counts(sass: str) -> dict[str, collections.Counter]:
    """Mangled kernel name -> its instructions counted by opcode (no modifiers)."""
    out = {}
    for m in re.finditer(r"Function : (\S+)(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", m.group(2))
        out[m.group(1)] = collections.Counter(op.split(".")[0] for op in ops)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("source", help="a file under tdnet_tpu_torch/csrc")
    parser.add_argument("kernels", nargs="+", help="fragments of the kernels' mangled names")
    args = parser.parse_args(argv)
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"sass-{os.getpid()}.so")
    try:
        build = subprocess.run([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                                os.path.join(CSRC, args.source)],
                               capture_output=True, text=True, check=True)
        cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
    finally:
        if os.path.exists(lib):
            os.remove(lib)
    info, counts = ptxas_info(build.stdout + build.stderr), opcode_counts(sass)
    for name, ops in counts.items():
        if any(f in name for f in args.kernels):
            print(f"{name[:110]}:{info.get(name, '')}")
            print(f"  {sum(ops.values())} instructions: "
                  + ", ".join(f"{op} {n}" for op, n in ops.most_common(18)))
            print("  products: " + ", ".join(f"{op} {ops[op]}" for op in PRODUCTS))
    for line in (build.stdout + build.stderr).splitlines():
        if "warning" in line:
            print(line.strip())


if __name__ == "__main__":
    main()
