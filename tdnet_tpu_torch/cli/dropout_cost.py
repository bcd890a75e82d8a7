"""K3's kernel by variants on the card: builds of ``csrc/dropout.cu`` with one
edit each, and other sources of it, each timed beside the shipped build.

    python -m tdnet_tpu_torch.cli.dropout_cost [--parent DIR] [--source NAME=FILE ...]

Builds each variant (one ``nvcc`` each, all at once, with ``-Xptxas -v``)
into ``build/tdnet_tpu_torch/dropout_cost/``:

- ``shipped``: the source as it is (one 16-byte vector a thread in at most
  8,192 blocks, the hash's high half formed once a vector);
- ``high_once``: the high half of the high word 0, which the compiler forms
  once a thread: right only where every index is below 2^32, as at every
  shape here, so it prices forming the high half once a vector;
- ``wave1``, ``wave2``: the grid capped at one or two waves (132 SMs x 8
  blocks of 256 threads, the H100 SXM's), a thread striding over several
  vectors; ``wave1_high_once``: both edits;
- ``parent``: ``DIR/tdnet_tpu_torch/csrc/dropout.cu`` (``--parent``), and
  ``NAME``: ``FILE`` (``--source``, repeatable), each a ``dropout.cu`` with
  the shipped C interface, built where it lies (beside its headers).

For each variant it prints ptxas's registers and spills of its vector
kernels; then, in f32 and bf16 at [18,721, 512] and [2,145, 512]
(``chip_smoke.DROP_ROWS``): whether its output is the shipped build's bits
and ``dropout_plain``'s, and the device ms of one launch (``torch.profiler``
traces of 20 or more launches a step) against the bound (bytes at 3.35
TB/s), the median and range of 3 rounds, in three cases (``sweep``): warm,
cold, and as in the train step. Run from the root of a checkout (it imports
``chip_smoke``); needs ``nvcc`` and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from tdnet_tpu_torch.cli.profile import kernel_family
from tdnet_tpu_torch.cli.sass import ptxas_info
from tdnet_tpu_torch.kernels import dropout as kd
from tdnet_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc

HIGH = ("tdnet_hash_high(seed_mix, (uint32_t)(e >> 32))", "tdnet_hash_high(seed_mix, 0)")
GRID = "constexpr size_t MAX_BLOCKS = 8192;"
WAVE = 132 * 8   # blocks resident at once: the H100 SXM's SMs x 2,048 / 256 threads
# variant: its edits of dropout.cu, (text, replacement) pairs
VARIANTS = {
    "shipped": (),
    "high_once": (HIGH,),
    "wave1": ((GRID, f"constexpr size_t MAX_BLOCKS = {WAVE};"),),
    "wave2": ((GRID, f"constexpr size_t MAX_BLOCKS = {2 * WAVE};"),),
    "wave1_high_once": (HIGH, (GRID, f"constexpr size_t MAX_BLOCKS = {WAVE};")),
}
RATE = 0.1


def build_all(others: dict[str, str]) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Each variant's library (its C interface declared) and ptxas's output,
    built concurrently; ``others``: name -> a ``dropout.cu`` built in place."""
    with open(os.path.join(CSRC, "dropout.cu")) as f:
        source = f.read()
    jobs = {}
    for name, edits in VARIANTS.items():
        folder = os.path.join(BUILD_DIR, "dropout_cost", name)
        shutil.rmtree(folder, ignore_errors=True)
        shutil.copytree(CSRC, folder)
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in dropout.cu")
            text = text.replace(old, new)
        with open(os.path.join(folder, "dropout.cu"), "w") as f:
            f.write(text)
        jobs[name] = os.path.join(folder, "dropout.cu")
    jobs.update(others)
    procs = {}
    for name, source_path in jobs.items():
        lib = os.path.join(BUILD_DIR, "dropout_cost", f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, source_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        libs[name] = (kd.declare(ctypes.CDLL(path)), out)
    return libs


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="a parent checkout whose csrc/dropout.cu to time too")
    parser.add_argument("--source", action="append", default=[], metavar="NAME=FILE",
                        help="another dropout.cu with the shipped C interface")
    args = parser.parse_args(argv)
    import chip_smoke as smoke
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    others = dict(s.split("=", 1) for s in args.source)
    if args.parent:
        others["parent"] = os.path.join(args.parent, "tdnet_tpu_torch", "csrc", "dropout.cu")
    libs = build_all(others)
    for name, (_, log) in libs.items():
        regs = {k: v for k, v in ptxas_info(log).items()
                if "dropout_vec" in k or "dropout_bf16x8" in k}
        print(f"{name}: " + "; ".join(f"{k}:{v}" for k, v in regs.items()))
    for dtype in (torch.float32, torch.bfloat16):
        for rows in smoke.DROP_ROWS:
            sweep(libs, smoke, dtype, rows)


def sweep(libs, smoke, dtype, rows) -> None:
    """Every variant at one (dtype, rows): its bits against the shipped build's,
    then its device ms a launch in three cases, 3 rounds with the variants in
    turns: ``warm``, one buffer launched back to back (38 MB of bf16 in and
    out at 18,721 rows fits the 50 MB L2); ``cold``, launches rotating over as
    many buffers as hold 200 MB; ``step``, x written just before each launch
    by ``matmul(h, w) + b``, as the train step's fc writes K3's input
    (``nn/encoding.py:apply_attention``)."""
    entry, _, seed, threshold, inv_keep = kd.launch_args(0, dtype, RATE, smoke.SEED)
    gen = torch.Generator().manual_seed(rows)
    nbytes = 2 * dtype.itemsize * rows * smoke.D_V
    pairs = [(torch.randn(rows, smoke.D_V, generator=gen).to("cuda", dtype),
              torch.empty(rows, smoke.D_V, dtype=dtype, device="cuda"))
             for _ in range(-(-200_000_000 // nbytes))]
    h = torch.randn(rows, smoke.D_V, generator=gen).to("cuda", dtype)
    w = (torch.randn(smoke.D_V, smoke.D_V, generator=gen) / smoke.D_V ** 0.5).to("cuda", dtype)
    b = torch.randn(smoke.D_V, generator=gen).to("cuda", dtype)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, pair):
        x, y = pair
        err = getattr(lib, entry)(x.data_ptr(), y.data_ptr(), x.numel(), seed, threshold,
                                  inv_keep, stream)
        if err != 0:
            raise RuntimeError(f"CUDA error {err}: {lib.tdnet_cuda_error_string(err).decode()}")

    def fc_then(lib):
        torch.add(torch.matmul(h, w), b, out=pairs[0][0])
        call(lib, pairs[0])

    x, y = pairs[0]
    call(libs["shipped"][0], pairs[0])
    want = y.clone()
    plain = torch.equal(want, kd.dropout_plain(x, RATE, smoke.SEED))
    bnd = smoke.bound(0, nbytes, smoke.PEAK_BF16)
    print(f"{str(dtype)[6:]} [{rows}, {smoke.D_V}]: shipped == dropout_plain {plain}; bound "
          f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}; cold over {len(pairs)} buffers")
    if not plain:
        raise AssertionError("the shipped build differs from dropout_plain")
    cases = {"warm": lambda lib: [call(lib, pairs[0]) for _ in range(20)],
             "cold": lambda lib: [call(lib, p) for p in pairs * -(-20 // len(pairs))],
             "step": lambda lib: [fc_then(lib) for _ in range(20)]}
    launches = {"warm": 20, "cold": len(pairs) * -(-20 // len(pairs)), "step": 20}
    times = {(name, how): [] for name in libs for how in cases}
    for _ in range(3):   # in turns
        for name, (lib, _) in libs.items():
            for how, run in cases.items():
                traced = smoke.device_rows(lambda: run(lib))
                if traced is not None:
                    times[name, how].append(sum(
                        t for k, t in traced if kernel_family(k, train=True) == "K3 dropout")
                        / launches[how])
    call(libs["shipped"][0], pairs[0])   # x is now the step case's
    want = y.clone()
    for name, (lib, _) in libs.items():
        y.zero_()
        call(lib, pairs[0])
        same = torch.equal(y, want)
        parts = []
        for how in cases:
            t = times[name, how]
            if not t:
                parts.append(f"{how} not measured")
                continue
            med = float(np.median(t))
            parts.append(f"{how} {med:.5f} ({min(t):.5f}-{max(t):.5f}; "
                         f"{bnd['bound_ms'] / med:.3f} of the bound)")
        print(f"  {name:15s} shipped bits {same}; device ms a launch: " + ", ".join(parts))
        if not same:
            raise AssertionError(f"variant {name} differs from the shipped build")


if __name__ == "__main__":
    main()
