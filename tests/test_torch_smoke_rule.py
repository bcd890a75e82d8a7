"""The rules by which ``chip_smoke.py`` phase 9 holds the train step's kernel
path (K2 and K3) and phase 14 its K5 path, on synthetic gradient dicts, and
phase 9's probe on the CPU.

``against_f64`` holds a path to a float64 run beside the plain f32 path: the
losses within 1e-4 relative, each gradient no farther from float64 than
twice the plain path's distance plus 1e-3 x max(max|grad|, floor).
``kernel_vs_plain`` holds the kernel path to the plain path: the loss
within 1e-4 relative, each gradient within 1e-3 x max(max|grad|, floor)
plus twice its run-to-run difference.
Phase 9 gates on both (``check_path``): on the card a forward that rounds
otherwise than the plain path's GEMM flips ReLUs and fails the second while
it passes the first, and a forward off by 1e-3 on one 64-row q block passes
the first and fails the second (PERF.md, run A1). The numbers below
mimic those cases: gradients whose largest entry is 1, an f32 path's rounding
1e-7 of it, a flipped ReLU a few 1e-3 of it.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from tdnet_tpu_torch.nn import encoding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

NAMES = ("ln.bias", "ln.weight", "conv.weight", "bn.bias")
LOSS = 10.048104


def _reference(seed: int = 0) -> dict:
    """float64 gradients, each with max|grad| 1, but bn.bias, which vanishes
    in exact arithmetic (below the floor)."""
    rng = np.random.RandomState(seed)
    grads = {}
    for name in NAMES:
        g = rng.randn(64)
        grads[name] = torch.from_numpy(g / np.abs(g).max())
    grads["bn.bias"] = grads["bn.bias"] * 1e-9
    return grads


def _f32_path(ref: dict, seed: int, flips: dict | None = None) -> dict:
    """An f32 path: each gradient rounded to f32 with 1e-7 of noise, plus, in
    ``flips`` (name -> (index, size)), one entry moved by ``size`` as a
    flipped ReLU moves it."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, g in ref.items():
        noise = torch.from_numpy(rng.randn(*g.shape)) * 1e-7 * g.abs().max()
        out[name] = (g + noise).float()
    for name, (index, size) in (flips or {}).items():
        out[name][index] += size
    return out


def _noise(grads: dict, size: float = 1e-6) -> dict:
    return {k: size * g.abs().max().item() for k, g in grads.items()}


def test_the_float64_rule_passes_a_path_closer_to_float64_than_the_plain_path():
    """The D2-D4 case (PERF.md): the two f32 paths flip different ReLUs, so they
    lie 1e-2 of max|grad| apart on ln.bias, ten times the kernel-vs-plain
    limit (run D2: 19 times), while the kernel path lies closer to float64
    than the plain one."""
    ref = _reference()
    plain = _f32_path(ref, 1, flips={"ln.bias": (3, 1e-2)})
    kernel = _f32_path(ref, 2, flips={"ln.bias": (7, -8e-3)})
    assert (kernel["ln.bias"] - plain["ln.bias"]).abs().max() > 1e-3
    held = smoke.against_f64((LOSS, kernel), (LOSS, plain), (LOSS, ref))
    assert held.problem == "", held.problem
    assert held.worst == (pytest.approx(8e-3 / 2.1e-2, rel=1e-3), "ln.bias")
    assert held.plain_term == 1 and held.beyond == 1
    old = smoke.kernel_vs_plain((LOSS, kernel), (LOSS, plain), _noise(kernel))
    assert old["problem"].startswith("gradient ln.bias") and old["worst"][0] > 9


def test_the_float64_rule_fails_the_probe_at_1e_2():
    """K2's forward off by 1e-2 on one q block (run A1: 9.3 of the limit with
    dropout off, on atn.1.2.w): a gradient moved far beyond twice the plain
    path's distance plus 1e-3 x max|grad|."""
    ref = _reference()
    plain = _f32_path(ref, 1, flips={"ln.bias": (3, 3e-3)})
    probe = _f32_path(ref, 2, flips={"ln.bias": (7, -2e-3), "conv.weight": (11, 6e-2)})
    held = smoke.against_f64((LOSS, probe), (LOSS, plain), (LOSS, ref))
    assert held.problem.startswith("gradient conv.weight"), held.problem
    assert held.worst[1] == "conv.weight" and held.worst[0] > 9


def test_the_check_flags_the_probe_at_1e_3_through_the_kernel_vs_plain_rule():
    """K2's forward off by 1e-3 on one q block (run A1: 0.988 of the float64
    limit, 37.8 of the kernel-vs-plain one, dropout off): the float64 rule
    passes it and phase 9's check, both rules, flags it."""
    ref = _reference()
    plain = _f32_path(ref, 1, flips={"ln.weight": (3, 3e-3)})
    probe = _f32_path(ref, 2, flips={"ln.weight": (9, 6.9e-3)})
    noise = _noise(plain, 1e-7)
    problem, held, old = smoke.check_path((LOSS, probe), (LOSS, plain), (LOSS, ref), noise)
    assert held.problem == "" and held.worst == (pytest.approx(6.9 / 7, rel=1e-3), "ln.weight")
    assert old["problem"].startswith("gradient ln.weight") and problem == old["problem"]


@pytest.mark.parametrize("missing_from", ["kernel", "plain"])
def test_the_float64_rule_fails_a_gradient_set_missing_a_key(missing_from):
    ref = _reference()
    paths = dict(kernel=_f32_path(ref, 2), plain=_f32_path(ref, 1))
    del paths[missing_from]["conv.weight"]
    held = smoke.against_f64((LOSS, paths["kernel"]), (LOSS, paths["plain"]), (LOSS, ref))
    assert held.problem == "gradient sets differ on ['conv.weight']"


@pytest.mark.parametrize("rel,ok", [(5e-5, True), (2e-4, False)])
def test_the_float64_rule_holds_both_losses_to_1e_4(rel, ok):
    ref = _reference()
    path = _f32_path(ref, 2)
    for kernel_loss, plain_loss in ((LOSS * (1 + rel), LOSS), (LOSS, LOSS * (1 - rel))):
        held = smoke.against_f64((kernel_loss, path), (plain_loss, path), (LOSS, ref))
        assert (held.problem == "") == ok, held.problem
        assert held.rel == pytest.approx(rel)


def test_a_vanishing_gradient_is_held_to_the_floor():
    """bn.bias is 1e-9 in float64: its limit is 1e-3 x the floor (1e-5 x the
    largest max|grad|), so a path 5e-9 off passes and one 5e-8 off fails."""
    ref = _reference()
    plain = _f32_path(ref, 1)
    for size, ok in ((5e-9, True), (5e-8, False)):
        path = _f32_path(ref, 2, flips={"bn.bias": (0, size)})
        held = smoke.against_f64((LOSS, path), (LOSS, plain), (LOSS, ref))
        assert held.floor == pytest.approx(smoke.GRAD_FLOOR)
        assert (held.problem == "") == ok, (size, held.problem)


def test_the_kernel_vs_plain_rule_adds_twice_the_run_to_run_difference():
    ref = _reference()
    plain = _f32_path(ref, 1)
    path = _f32_path(ref, 1, flips={"ln.bias": (0, 2e-3)})
    assert smoke.kernel_vs_plain((LOSS, path), (LOSS, plain), _noise(plain, 1e-7))["problem"]
    found = smoke.kernel_vs_plain((LOSS, path), (LOSS, plain),
                                  {**_noise(plain, 1e-7), "ln.bias": 6e-4})
    assert found["problem"] == "" and found["needed"] == 1
    assert found["worst"] == (pytest.approx(2e-3 / (1e-3 + 1.2e-3), rel=1e-3), "ln.bias")


@pytest.mark.parametrize("rel,ok", [(5e-5, True), (2e-4, False)])
def test_the_kernel_vs_plain_rule_holds_the_loss_to_1e_4(rel, ok):
    """The kernel path's loss within 1e-4 relative of the plain path's, the
    gradients equal: the rule's loss term alone decides."""
    ref = _reference()
    path = _f32_path(ref, 2)
    found = smoke.kernel_vs_plain((LOSS * (1 + rel), path), (LOSS, path), _noise(path))
    assert (found["problem"] == "") == ok, found["problem"]
    assert found["problem"].startswith("" if ok else "loss ")


@pytest.mark.parametrize("missing_from", ["kernel", "plain"])
def test_the_kernel_vs_plain_rule_fails_a_gradient_set_missing_a_key(missing_from):
    ref = _reference()
    paths = dict(kernel=_f32_path(ref, 2), plain=_f32_path(ref, 1))
    del paths[missing_from]["conv.weight"]
    found = smoke.kernel_vs_plain((LOSS, paths["kernel"]), (LOSS, paths["plain"]),
                                  _noise(paths["kernel"]))
    assert found["problem"] == "gradient sets differ on ['conv.weight']"


def test_the_probe_moves_one_q_block_of_the_last_hop_and_not_its_backward():
    """``faulty_forward`` multiplies rows PROBE_ROWS of the last hop's output
    by 1 + eps; other hops pass untouched, and the gradient that flows into
    the attention is the unperturbed one."""
    gen = torch.Generator().manual_seed(0)
    eps, rows = 1e-3, smoke.PROBE_ROWS
    for lq in (smoke.PROBE_LQ, 2145):
        q = torch.randn(1, lq, 64, generator=gen).requires_grad_(True)
        k = torch.randn(1, 8, 64, generator=gen)
        v = torch.randn(1, 8, 128, generator=gen).requires_grad_(True)
        w = torch.randn(1, lq, 128, generator=gen)
        outs, grads = [], []
        for probe in (False, True):
            with smoke.faulty_forward(eps) if probe else contextlib.nullcontext():
                o = encoding.propagation_attention_train(q, k, v, temperature=8.0)
            q.grad = v.grad = None
            (o * w).sum().backward()
            outs.append(o.detach())
            grads.append((q.grad.clone(), v.grad.clone()))
        want = outs[0].clone()
        if lq == smoke.PROBE_LQ:
            want[:, rows] += eps * outs[0][:, rows]
        assert torch.equal(outs[1], want)
        assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert encoding.propagation_attention_train.__name__ == "propagation_attention_train"


def test_the_probe_is_one_q_block_of_the_recipe_s_last_hop():
    """18,721 = 97 x 193 queries: the H/8 grid of the 769x1537 crop."""
    assert smoke.PROBE_LQ == smoke.TRAIN_SHAPES[-1][0] == 97 * 193
    assert smoke.PROBE_ROWS.stop - smoke.PROBE_ROWS.start == 64
    assert smoke.PROBE_ROWS.start % 64 == 0 and smoke.PROBE_ROWS.stop <= smoke.PROBE_LQ
