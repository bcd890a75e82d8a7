"""K5's bf16 kernel costed by parts on the card: copies of its source with a
part cut out or changed, each built and timed beside the shipped kernel.

    python -m tdnet_tpu_torch.cli.dilated_conv_cost [--phase16]

Builds each variant of ``csrc/dilated_conv.cu`` (one ``nvcc`` each, all at
once, with ``-Xptxas -v``) into ``build/tdnet_tpu_torch/cost/``:

- ``shipped``: the source as it is (a stage one tap and 64 channels,
  tap-major, a chain a stage);
- ``go_on``: a consumer that gives up on a barrier sets the error word and
  goes on instead of exiting (``bar_wait_or_flag``), so that ptxas need not
  wait for each ``wgmma`` as it issues (it does for the exit: C7518);
- ``no_products``: no ``wgmma``: the loads, the barriers, the adds and the
  stores;
- ``no_loads``: the producer fills each ring slot once and then only arrives,
  so the products run on stale tiles: the products, the adds and the stores;
- ``six_stages``: a ring of six stages;
- ``kernel_row``: a stage one kernel row and 64 channels, 3 stages: one box
  of BM + 2d input rows whose three taps are row shifts of it (A from L2 once
  a row instead of once a tap), the three taps one chain; dilation 16 at most.

For each it prints ptxas's notes on ``wgmma`` (C75xx), the HGMMA and
``WARPGROUP.DEPBAR`` count of ``dil_wgmma``, the median of 5 rounds of 50
calls (CUDA events; ms a call, the prep passes included) at 512->512 on
97x193 with dilation 4 and 16, in turns, whether its output is the shipped
kernel's bits and phase 13b's rounding gate against the plain version
(``chip_smoke.rounding_gate``), on ``randn`` input and on a ReLU's output
(the recipes' input to a conv: non-negative, many zeros) with the rms
distance from a float64 conv in bf16 ulps; then the shipped call's kernels
with their device times (``torch.profiler``). ``--phase16``: then phase 9's
float64 run and phase 16's rule (``chip_smoke.compare_with_f64``, dropout
off and on) with the shipped and the kernel-row kernels. Run from the root
of a checkout (it imports ``chip_smoke``); needs ``nvcc``, ``cuobjdump`` and
a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import torch

from tdnet_tpu_torch.kernels import dilated_conv as dc
from tdnet_tpu_torch.kernels.build import BUILD_DIR, CSRC, NVCC_FLAGS, nvcc

PRODUCTS = "      wgmma_ss_128<0>(c, a + 2 * kk, w + 2 * kk, kk);"
LOAD = "      bar_expect(full, STAGE);\n"
STAGES = "constexpr int STAGES = 4;"
# a consumer's wait that sets the error word after TDNET_CONSUMER_POLLS tries and goes on
GO_ON = """    {
      uint32_t done = 0;
      for (int tries = 0; !done && tries < TDNET_CONSUMER_POLLS; ++tries)
        asm volatile(
            "{\\n .reg .pred p;\\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"
            " selp.u32 %0, 1, 0, p;\\n}\\n"
            : "=r"(done)
            : "r"(saddr(ring.full + in)), "r"(in_phase)
            : "memory");
      if (!done) atomicExch(fault, 1u);
    }"""
# the kernel-row design: a box of BM + 2d rows (at most 160: d <= 16) and three taps' weights
KERNEL_ROW = [
    ("constexpr int A_BYTES = BM * ROW;", "constexpr int A_BYTES = (BM + 32) * ROW;"),
    ("constexpr int STAGE = A_BYTES + BN * ROW;", "constexpr int STAGE = A_BYTES + 3 * BN * ROW;"),
    (STAGES, "constexpr int STAGES = 3;"),
    ("  const int steps = 9 * kc;", "  const int steps = 3 * kc;"),
    ("""      const int tap = s / kc, c0 = (s - tap * kc) * BK_BF16;
      unsigned char* st = ring.base + (s % STAGES) * STAGE;
      uint64_t* full = ring.full + s % STAGES;
      bar_expect(full, STAGE);
      tma_load_3d(st, &tm_x, c0, m0 + (tap / 3) * dil * Wp + (tap % 3) * dil, b, full);
      tma_load_3d(st + A_BYTES, &tm_w, c0, n0, tap, full);""",
     """      const int i = s / kc, c0 = (s - i * kc) * BK_BF16;
      unsigned char* st = ring.base + (s % STAGES) * STAGE;
      uint64_t* full = ring.full + s % STAGES;
      bar_expect(full, (BM + 2 * dil) * ROW + 3 * BN * ROW);
      tma_load_3d(st, &tm_x, c0, m0 + i * dil * Wp, b, full);
      for (int j = 0; j < 3; ++j)
        tma_load_3d(st + A_BYTES + j * BN * ROW, &tm_w, c0, n0, 3 * i + j, full);"""),
    ("""    for (int kk = 0; kk < 4; ++kk)   // 32 bytes a step: 2 in the descriptor's units
""" + PRODUCTS, """    for (int j = 0; j < 3; ++j)
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_128<0>(c, a + j * (dil * ROW >> 4) + 2 * kk, w + j * (BN * ROW >> 4) + 2 * kk,
                        j + kk);"""),
    ("bf16_tensor_map(&tx, xs, Kp, (uint64_t)hr * g.Wp, n, BM)",
     "bf16_tensor_map(&tx, xs, Kp, (uint64_t)hr * g.Wp, n, BM + 2 * dil)"),
]
# variant: (old, new) replacements in the source
VARIANTS = {
    "shipped": [],
    "go_on": [("    bar_wait_or_flag(ring.full + in, in_phase, fault);", GO_ON)],
    "no_products": [(PRODUCTS, "      ;")],
    "no_loads": [(LOAD, "      if (s >= STAGES) {\n        bar_arrive(full);\n        continue;\n"
                        "      }\n" + LOAD)],
    "six_stages": [(STAGES, "constexpr int STAGES = 6;")],
    "kernel_row": KERNEL_ROW,
}
SHAPES = [(512, 512, 4), (512, 512, 16)]   # layer4's (ci, co, dilation) on the 97x193 grid
GRID = (97, 193)


def build_all() -> dict[str, tuple[ctypes.CDLL, str]]:
    """Each variant's library and ptxas's output, built concurrently."""
    with open(os.path.join(CSRC, "dilated_conv.cu")) as f:
        source = f.read()
    jobs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        folder = os.path.join(BUILD_DIR, "cost", name)
        shutil.rmtree(folder, ignore_errors=True)
        shutil.copytree(CSRC, folder)
        with open(os.path.join(folder, "dilated_conv.cu"), "w") as f:
            f.write(text)
        lib = os.path.join(folder, "lib.so")
        jobs[name] = (lib, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
             os.path.join(folder, "dilated_conv.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.tdnet_dilated_conv_bf16.argtypes = [p] * 6 + [i] * 11 + [p]
        lib.tdnet_dilated_conv_bf16.restype = ctypes.c_int
        lib.tdnet_cuda_error_string.argtypes = [i]
        lib.tdnet_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = (lib, out)
    return libs


def sass_counts(path: str) -> tuple[int, int]:
    """dil_wgmma's HGMMA and WARPGROUP.DEPBAR instructions."""
    cuobjdump = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    body = "".join(f for f in sass.split("Function : ") if "dil_wgmma" in f[:200])
    return body.count("HGMMA"), body.count("WARPGROUP.DEPBAR")


def ms_per_call(fn, calls: int = 50) -> float:
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def rounding(libs, smoke) -> None:
    """Each computing variant's bits, gate and rms distance from float64 at 512->512 d4."""
    gen = torch.Generator().manual_seed(1)
    for relu in (False, True):
        x = torch.randn(1, 512, *GRID, generator=gen)
        x = (x.relu() if relu else x).to("cuda", torch.bfloat16)
        w = (torch.randn(512, 512, 3, 3, generator=gen) / 4608 ** 0.5).to("cuda", torch.bfloat16)
        exact = dc.dilated_conv_plain(x.double(), w.double(), 4, 4)
        plain = dc.dilated_conv_plain(x, w, 4, 4)
        rms = lambda y: (((y.double() - exact) / smoke.bf16_ulp(exact)) ** 2).mean().sqrt().item()
        ref = dc.launch(x, w, 4, 4, lib=libs["shipped"][0])
        print(f"{'relu' if relu else 'randn'} input, 512->512 d4: plain rms {rms(plain):.3f} ulp")
        for name in ("shipped", "go_on", "six_stages", "kernel_row"):
            y = dc.launch(x, w, 4, 4, lib=libs[name][0])
            bias, plain_bias, ok = smoke.rounding_gate(y, plain, exact)
            print(f"  {name:12s} the shipped bits {torch.equal(y, ref)}, "
                  f"{(y != plain).double().mean().item():.4%} off the plain bits, rms "
                  f"{rms(y):.3f} ulp, bias {bias:+.2e} (plain {plain_bias:+.2e}, gate {ok})")


def phase16(libs, smoke) -> None:
    """Phase 16's rule with the shipped and the kernel-row kernels in the bf16 recipe."""
    from tdnet_tpu_torch.train.trainer import make_loss_of
    card = smoke.phase_toolchain()
    (state, start, teacher, frames, labels, loss_fn, refs), _ = smoke.phase_train(card)
    build = dc.build
    try:
        for name in ("shipped", "kernel_row"):
            dc.build = lambda defines=(), lib=libs[name][0]: lib
            for use_dropout in (False, True):
                try:
                    smoke.compare_with_f64(make_loss_of, loss_fn, state.model, start, teacher,
                                           frames, labels, refs[use_dropout], use_dropout,
                                           compute_dtype=torch.bfloat16, tag=f"16 {name}")
                    print(f"phase 16 rule, {name}, dropout {use_dropout}: passed")
                except AssertionError as e:
                    print(f"phase 16 rule, {name}, dropout {use_dropout}: failed: {e}")
    finally:
        dc.build = build


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase16", action="store_true",
                        help="also phase 16's rule with the shipped and kernel-row kernels")
    args = parser.parse_args(argv)
    import chip_smoke as smoke
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libs = build_all()
    for name, (lib, log) in libs.items():
        notes = sorted(set(re.findall(r"\((C75\d\d)\)", log)))
        hgmma, depbar = sass_counts(lib._name)
        print(f"{name}: ptxas wgmma notes {notes or 'none'}; HGMMA {hgmma}, "
              f"WARPGROUP.DEPBAR {depbar}")
    gen = torch.Generator().manual_seed(0)
    for ci, co, d in SHAPES:
        x = torch.randn(1, ci, *GRID, generator=gen).to("cuda", torch.bfloat16)
        w = (torch.randn(co, ci, 3, 3, generator=gen) / (9 * ci) ** 0.5).to("cuda",
                                                                            torch.bfloat16)
        times = {name: [] for name in libs}
        for _ in range(5):   # in turns
            for name, (lib, _) in libs.items():
                times[name].append(ms_per_call(lambda: dc.launch(x, w, d, d, lib=lib)))
        for name in libs:
            print(f"{ci}->{co} d{d} {name:12s} {float(np.median(times[name])):.4f} ms a call "
                  f"(5 rounds {min(times[name]):.4f}-{max(times[name]):.4f})")
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(10):
                dc.launch(x, w, d, d, lib=libs["shipped"][0])
            torch.cuda.synchronize()
        for row in prof.key_averages():
            if row.device_type == torch.autograd.DeviceType.CUDA:
                print(f"  shipped {ci}->{co} d{d} device ms: {row.key[:70]} "
                      f"{row.self_device_time_total / 1e3 / 10:.4f}")
    rounding(libs, smoke)
    if args.phase16:
        phase16(libs, smoke)


if __name__ == "__main__":
    main()
