"""The port's streaming slice against the JAX package, and the port's
entry points: no JAX behind ``import tdnet_tpu_torch``, and the CLI.

Same weights (JAX ``init_tdnet`` through ``utils/from_jax.py``) and the same
frames (numpy, seeded) go through both; f32 on the CPU, where the port's
attention wrapper takes its plain version.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tdnet_tpu.data.streaming import normalize_frame
from tdnet_tpu.models.tdnet import TDNetConfig as JaxConfig
from tdnet_tpu.models.tdnet import init_tdnet as jax_init_tdnet
from tdnet_tpu.stream.runtime import Streamer as JaxStreamer
from tdnet_tpu_torch.models import TDNetConfig
from tdnet_tpu_torch.cli.profile import kernel_family
from tdnet_tpu_torch.stream.runtime import LatencyMeter, Streamer, synthetic_frames
from tdnet_tpu_torch.utils.from_jax import tdnet_from_jax

IN_SIZE = (97, 193)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", params=[4, 2], ids=["P4", "P2"])
def streams(request):
    """Per-frame logits of the JAX Streamer (reference dataflow and fused
    trunk) and of the port's Streamer in both forms over 2P+1 frames (cold
    and warm)."""
    p = request.param
    jcfg = JaxConfig(nclass=19, backbone="resnet10", path_num=p, in_size=IN_SIZE,
                     kv_stride=4, aux=False)
    params = jax_init_tdnet(jax.random.PRNGKey(p), jcfg)
    cfg = TDNetConfig(nclass=19, backbone="resnet10", path_num=p, in_size=IN_SIZE,
                      kv_stride=4)
    rng = np.random.RandomState(p)
    frames = [rng.randn(1, *IN_SIZE, 3).astype(np.float32) * 0.5
              for _ in range(2 * p + 1)]
    ref = JaxStreamer(params, jcfg, fused_trunk=False)
    fused = JaxStreamer(params, jcfg)
    port_ref = Streamer(tdnet_from_jax(params, cfg), fused_trunk=False)
    port = Streamer(tdnet_from_jax(params, cfg))
    out = {"ref": [], "fused": [], "port_ref": [], "port": []}
    for f in frames:
        out["ref"].append(np.asarray(ref.step(jnp.asarray(f), timed=False)[0]))
        out["fused"].append(np.asarray(fused.step(jnp.asarray(f), timed=False)[0]))
        out["port_ref"].append(port_ref.step(torch.from_numpy(f), timed=False)[0].numpy())
        out["port"].append(port.step(torch.from_numpy(f), timed=False)[0].numpy())
    return out


def test_stream_matches_reference_dataflow(streams):
    for i, (got, want) in enumerate(zip(streams["port_ref"], streams["ref"])):
        assert got.shape == want.shape == (1, *IN_SIZE, 19)
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"frame {i}")


def test_stream_matches_fused_trunk(streams):
    """The port's default stream is the fused trunk, as JAX's is."""
    for i, (got, want) in enumerate(zip(streams["port"], streams["fused"])):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=f"frame {i}")


def test_latency_meter_warmup_exclusion():
    m = LatencyMeter(warmup=6)
    for i in range(10):
        m.add(1.0 if i < 6 else 0.5)
    assert m.avg == 0.5 and m.fps == 2.0


def test_synthetic_frames_pan_a_seeded_scene():
    frames = synthetic_frames(3, (5, 7), seed=3)
    assert [tuple(f.shape) for f in frames] == [(1, 5, 7, 3)] * 3
    assert all(f.dtype == torch.float32 for f in frames)
    # frame t is the scene's columns t..t+W, normalized as the JAX loader does
    scene = np.random.RandomState(3).randint(0, 256, (5, 7 + 3, 3), dtype=np.uint8)
    for t, f in enumerate(frames):
        np.testing.assert_allclose(f[0].numpy(), normalize_frame(scene[:, t:t + 7]),
                                   atol=1e-6)
    np.testing.assert_array_equal(frames[1][0, :, :-1].numpy(), frames[0][0, :, 1:].numpy())
    again = synthetic_frames(3, (5, 7), seed=3, dtype=torch.bfloat16)
    assert again[2].dtype == torch.bfloat16
    torch.testing.assert_close(again[2].float(), frames[2].to(torch.bfloat16).float())


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::k1::attn_bf16<1, 128, 64, false>(CUtensorMap_st, ...)",
     "K1 propagation attention"),
    ("void (anonymous namespace)::k1::attn_bf16<1, 128, 64, true>(CUtensorMap_st, ...)",
     "K1 propagation attention"),
    ("void (anonymous namespace)::k1::fc_bf16<1, 128>(CUtensorMap_st, ...)",
     "K1 propagation attention"),
    ("(anonymous namespace)::stats_f32(float const*, ...)", "K1 propagation attention"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwc", "convolutions (cuDNN)"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "convolutions (cuDNN)"),
    ("void at::native::vectorized_elementwise_kernel<8, ...>",
     "elementwise (BN affine, activations, adds, casts)"),
    ("void at::native::(anonymous namespace)::adaptive_average_pool<float>(float const*, ...)",
     "adaptive pool"),
    ("Memcpy DtoD (Device -> Device)", "other"),
    ("void (anonymous namespace)::dkdv_tc<4, true>(float const*, ...)",
     "K2 training attention backward"),
    ("(anonymous namespace)::dq_tc(float const*, float const*, float*, ...)",
     "K2 training attention backward"),
    ("void (anonymous namespace)::pv_tc<512>(float const*, ...)", "K1 propagation attention"),
    ("void (anonymous namespace)::pv_fma<256, true>(float const*, ...)",
     "K1 propagation attention"),
    ("(anonymous namespace)::sum_parts(float4 const*, float4*, int, unsigned long)",
     "K1 propagation attention"),
    ("void (anonymous namespace)::fc_tc<256>(float const*, ...)", "K1 propagation attention"),
    ("(anonymous namespace)::dropout_vec4(float4 const*, ...)", "K3 dropout"),
    ("void (anonymous namespace)::stem_tc<(anonymous namespace)::Bf16>(__nv_bfloat16 const*, "
     "...)", "K4 fused stem"),
    ("void (anonymous namespace)::stem_tc<(anonymous namespace)::F32>(float const*, ...)",
     "K4 fused stem"),
    ("(anonymous namespace)::dil_tc(float const*, float const*, float const*, ...)",
     "K5 dilated conv"),
    ("(anonymous namespace)::prep_input(float const*, float*, float*, int, ...)",
     "K5 dilated conv"),
    ("(anonymous namespace)::prep_weights(float const*, float*, float*, int, ...)",
     "K5 dilated conv"),
    ("void (anonymous namespace)::dil_tc<(anonymous namespace)::F32>(float const*, ...)",
     "K5 dilated conv"),
    ("void (anonymous namespace)::dil_tc<(anonymous namespace)::Bf16>(__nv_bfloat16 const*, "
     "...)", "K5 dilated conv"),
    ("void (anonymous namespace)::prep_input<__nv_bfloat16>(__nv_bfloat16 const*, ...)",
     "K5 dilated conv"),
    ("void (anonymous namespace)::prep_weights<__nv_bfloat16>(__nv_bfloat16 const*, ...)",
     "K5 dilated conv"),
    ("void at::native::(anonymous namespace)::fused_dropout_kernel_vec<float, float, ...>",
     "other"),
])
def test_kernel_family(name, family):
    assert kernel_family(name) == family


def test_kernel_family_in_a_train_step():
    # the partial sums are K2's backward's in a train step, where K1 does not run
    name = "(anonymous namespace)::sum_parts(float4 const*, float4*, int, unsigned long)"
    assert kernel_family(name, train=True) == "K2 training attention backward"
    assert kernel_family("void (anonymous namespace)::pv_fma<512, true>(float const*, ...)",
                         train=True) == "K1 propagation attention"


def test_chip_smoke_imports_nothing_of_jax():
    """The card's smoke stands on the port alone: no import of jax or of the
    JAX package anywhere in it, lazy imports included."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "tdnet_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "tdnet_tpu"}, roots


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import tdnet_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tdnet_tpu_torch.__path__, "
        "'tdnet_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert 'tdnet_tpu_torch.cli.test' in mods, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def _cli_pngs(tmp_path, argv):
    import imageio.v2 as imageio
    from tdnet_tpu.data.synthetic import render_frame
    from tdnet_tpu_torch.cli.test import main
    src = tmp_path / "vid" / "clip"
    src.mkdir(parents=True)
    for t in range(3):
        imageio.imwrite(src / f"frame_{t:03d}.png", render_frame(t, (64, 128)))
    out = tmp_path / "out"
    main(["--img_path", str(tmp_path / "vid"), "--output_path", str(out),
          "--device", "cpu", "--in_size", "65", "129"] + argv)
    pngs = sorted(os.listdir(out / "clip"))
    assert pngs == [f"frame_{t:03d}.png" for t in range(3)]
    assert imageio.imread(out / "clip" / pngs[0]).shape == (65 // 4, 129 // 4, 3)


def test_cli_streams_pngs(tmp_path):
    _cli_pngs(tmp_path, ["--model", "td4-psp18"])


def test_cli_streams_td2_fa_pngs(tmp_path):
    """``--model td2-fa``: TD2-FANet, one sub-network a frame, its hop at d_v 256."""
    _cli_pngs(tmp_path, ["--model", "td2-fa"])


def test_cli_psp101_fused_stem_writes_pngs(tmp_path):
    """``--model psp101``: one PSPNet-101 forward a frame, the deep-base stem
    through the fused tail (its plain version on the CPU)."""
    _cli_pngs(tmp_path, ["--model", "psp101", "--stem_impl", "fused"])


@pytest.mark.parametrize("argv", [["--model", "psp101", "--_psp101_path", "CHECKPOINT"],
                                  ["--parallel", "spatial"]])
def test_cli_rejects_what_is_not_ported(argv, tmp_path):
    """--parallel spatial is not ported (group streaming is:
    ``tests/test_torch_parallel_stream.py``); a checkpoint file that holds
    nothing (here PSP-101's) raises an error that names it."""
    from tdnet_tpu_torch.cli.test import main
    ckpt = tmp_path / "psp101.pkl"
    ckpt.write_bytes(b"")
    error, match = ((ValueError, re.escape(f"{ckpt}: not a checkpoint")) if "CHECKPOINT" in argv
                    else (NotImplementedError, "not ported"))
    argv = [str(ckpt) if a == "CHECKPOINT" else a for a in argv]
    with pytest.raises(error, match=match):
        main(argv + ["--device", "cpu"])
