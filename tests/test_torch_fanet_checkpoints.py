"""TD2-FANet checkpoints in the port, against the JAX package's importers.

Reference files come from seeded port FATDs (BatchNorms, LayerNorms and biases
drawn) through the smoke's ``reference_state`` (``chip_smoke.py``): ``td2_fa``,
the reference's td2_fa training naming, and ``fanet_source``, a single-path
FANet (``resnet``, ``ffm_*``, ``clslayer_8``, ``clslayer_32``). The JAX
package's ``fatd_from_torch`` and ``fanet_bootstrap_from_checkpoint`` read the
same dicts (every key of the file read); their pytrees come over through
``utils/from_jax.fatd_state_from_jax``.

Tolerances: imports, the bootstrap and the conversion bitwise; the served
stream's logits against JAX's ``Streamer`` at 2e-5, and ``cli.test``'s saved
class maps those of the port's own ``Streamer`` on the same file. The served
model's BatchNorm variances are doubled: with ``seeded``'s draws a FANet's
activations grow to hundreds and the hop's scores to 2,000, where one f32
rounding of a score moves a softmax weight by 1e-3 in either package; doubled,
the scores reach 24 (a spread of 7 a row).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tdnet_tpu.models.fanet_td import FATDConfig as JaxConfig
from tdnet_tpu.stream.runtime import Streamer as JaxStreamer
from tdnet_tpu.utils import torch_import as jax_import
from tdnet_tpu.utils.checkpoint import save_best as jax_save_best
from tdnet_tpu_torch.cli import convert, test as cli_test, train as cli_train
from tdnet_tpu_torch.data.png import read_png, write_png
from tdnet_tpu_torch.data.streaming import CITYSCAPES_COLORS, FrameSource, decode_segmap
from tdnet_tpu_torch.models import init_fatd, tdnet_config
from tdnet_tpu_torch.stream.runtime import Streamer
from tdnet_tpu_torch.utils import torch_import
from tdnet_tpu_torch.utils.checkpoint import save_state
from tdnet_tpu_torch.utils.from_jax import fatd_state_from_jax
from tests.test_torch_reference_checkpoints import (Recording, assert_same, counted, imported,
                                                    numpy_sd)

IN = (64, 128)
PARTS = ("backbone", "ffm_32", "ffm_16", "ffm_8", "ffm_4", "head", "head_aux")


def fa_model(seed: int, in_size=IN):
    return chip_smoke.seeded_model("td2-fa", in_size, seed=seed)


def jax_cfg(cfg) -> JaxConfig:
    return JaxConfig(nclass=cfg.nclass, backbone=cfg.backbone, in_size=cfg.in_size)


def test_fatd_names_and_import_match_jax():
    model, cfg = fa_model(3)
    ref = chip_smoke.reference_state(model, cfg, "td2_fa")
    assert any(k.endswith("num_batches_tracked") for k in ref)
    assert {"atn1.fc.0.conv.weight", "head_aux2.conv_out.weight",
            "ffm_4_2.smooth.bn.running_var", "pretrained1.layer1.0.downsample.1.weight",
            "layer_norm2.ln.weight", "enc1.w_vs.0.conv.bias"} <= set(ref)
    rec = Recording(numpy_sd(ref))
    params = jax_import.fatd_from_torch(rec, jax_cfg(cfg))
    assert rec.read == counted(ref)
    got = torch_import.fatd_from_torch(ref, cfg)
    assert_same(got, fatd_state_from_jax(params, cfg))
    assert_same(got, model.state_dict())


def test_fanet_bootstrap_matches_jax():
    source, cfg = fa_model(5)
    src = chip_smoke.reference_state(source, cfg, "fanet_source")
    assert not any(k.startswith(("enc", "atn", "layer_norm", "paths")) for k in src)
    rec = Recording(numpy_sd(src))
    jax_out = jax_import.fanet_bootstrap_from_checkpoint(rec, jax_cfg(cfg),
                                                         {"paths": {}, "atn": None})
    assert rec.read == counted(src)
    fresh = init_fatd(cfg, torch.Generator().manual_seed(1)).state_dict()
    got = torch_import.fanet_bootstrap_from_checkpoint(src, cfg, fresh)
    want = dict(fresh)
    want.update(imported(jax_out, PARTS, cfg.path_num))
    assert_same(got, want)
    own = source.state_dict()
    for p in range(cfg.path_num):   # every path is the source's path 0
        assert_same({k: v for k, v in got.items() if k.startswith(f"paths.{p}.")
                     and k.split(".")[2] in PARTS},
                    {k.replace("paths.0.", f"paths.{p}.", 1): v for k, v in own.items()
                     if k.startswith("paths.0.") and k.split(".")[2] in PARTS})


def test_fatd_import_refuses_another_input_size():
    model, cfg = fa_model(3)
    ref = chip_smoke.reference_state(model, cfg, "td2_fa")
    with pytest.raises(ValueError, match="layer_norm1: the checkpoint's feature grid is"):
        torch_import.fatd_from_torch(ref, tdnet_config("td2-fa", in_size=(96, 192)))
    del ref["ffm_16_2.up.bn.running_mean"]
    with pytest.raises(KeyError, match="ffm_16_2.up.bn.running_mean"):
        torch_import.fatd_from_torch(ref, cfg)


def test_load_fatd_reads_the_three_kinds(tmp_path):
    model, cfg = fa_model(7)
    want = model.state_dict()
    files = {"reference": str(tmp_path / "ref.pkl"), "port": str(tmp_path / "port.pt")}
    chip_smoke.write_reference(files["reference"], chip_smoke.reference_state(model, cfg,
                                                                              "td2_fa"),
                               "module.")
    save_state(files["port"], want)
    params = jax_import.fatd_from_torch(numpy_sd(chip_smoke.reference_state(
        model, cfg, "td2_fa")), jax_cfg(cfg))
    files["jax"] = jax_save_best(str(tmp_path), "td2_fa", "cityscapes", step=0, params=params,
                                 best_iou=0.5)
    for kind, path in files.items():
        assert torch_import.checkpoint_kind(path)[1] == kind
        got = torch_import.load_fatd(init_fatd(cfg, torch.Generator().manual_seed(9)), path)
        assert_same(got.state_dict(), want)


def test_convert_then_serve_matches_jax(tmp_path, capsys):
    """``cli.convert --arch td2_fa`` on a reference file, then ``cli.test --model
    td2-fa`` on the converted file: the conversion bitwise the seeded model, the
    stream JAX's on the reference file, the saved class maps the port's."""
    size = (96, 192)
    model, cfg = fa_model(11, size)
    for name, buf in model.named_buffers():
        if name.endswith("running_var"):
            buf.mul_(2.0)
    ref = chip_smoke.reference_state(model, cfg, "td2_fa")
    src, dst = str(tmp_path / "td2-fa.pkl"), str(tmp_path / "td2-fa.pt")
    chip_smoke.write_reference(src, ref)
    convert.main(["--arch", "td2_fa", "--src", src, "--dst", dst,
                  "--in_size", str(size[0]), str(size[1])])
    assert_same(torch.load(dst, weights_only=True)["model_state"], model.state_dict())
    frames = tmp_path / "frames" / "clip"
    frames.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for t in range(5):
        write_png(str(frames / f"f{t}.png"), rng.randint(0, 256, (90, 180, 3)).astype(np.uint8))
    out = tmp_path / "out"
    capsys.readouterr()
    cli_test.main(["--img_path", str(frames.parent), "--output_path", str(out), "--model",
                   "td2-fa", "--_td2_fa_path", dst, "--device", "cpu",
                   "--in_size", str(size[0]), str(size[1])])
    printed = capsys.readouterr().out
    assert f"Loading pretrained model from '{dst}'" in printed and "Model: td2-fa" in printed
    port = Streamer(torch_import.load_fatd(init_fatd(cfg, torch.Generator()), dst))
    jcfg = jax_cfg(cfg)
    jax_stream = JaxStreamer(jax_import.fatd_from_torch(numpy_sd(ref), jcfg), jcfg)
    rows = np.arange(size[0] // 4) * size[0] // (size[0] // 4)
    cols = np.arange(size[1] // 4) * size[1] // (size[1] // 4)
    for i, (x, name, folder, _) in enumerate(FrameSource(str(frames.parent), size)):
        got = port.step(torch.from_numpy(x), timed=False)[0]
        want = np.asarray(jax_stream.step(jnp.asarray(x), timed=False)[0])
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5, err_msg=f"frame {i}")
        pred = got[0].argmax(-1).to(torch.uint8).numpy()
        assert np.array_equal(read_png(str(out / folder / name)),
                              decode_segmap(pred[rows][:, cols], CITYSCAPES_COLORS))
    assert i == 4


def test_convert_bootstrap_is_what_train_makes(tmp_path):
    """``cli.convert --arch td2_fa --bootstrap`` on a single-path FANet file:
    ``cli.train``'s loader reads the converted file as it is, and its copied
    parts are those the loader makes from the source itself."""
    source, cfg = fa_model(13)
    src = str(tmp_path / "fanet18.pkl")
    chip_smoke.write_reference(src, chip_smoke.reference_state(source, cfg, "fanet_source"))
    dst = str(tmp_path / "td2_fa_bootstrap.pt")
    convert.main(["--arch", "td2_fa", "--bootstrap", "--src", src, "--dst", dst,
                  "--in_size", str(IN[0]), str(IN[1])])
    fresh = lambda: init_fatd(cfg, torch.Generator().manual_seed(cli_train.SEED))
    got = cli_train.load_student(fresh(), dst).state_dict()
    assert_same(got, torch.load(dst, weights_only=True)["model_state"])
    want = cli_train.load_student(fresh(), src).state_dict()
    copied = lambda sd: {k: v for k, v in sd.items() if k.split(".")[2] in PARTS}
    assert_same(copied(got), copied(want))
