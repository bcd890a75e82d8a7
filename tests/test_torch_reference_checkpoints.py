"""The reference's checkpoints in the port, against the JAX package's importers.

Reference files are built here from seeded port models by the smoke's
``reference_state`` (``chip_smoke.py``: the reference's key names, with
``num_batches_tracked`` beside each BatchNorm) and written as the reference's
PyTorch 1.1 did (``write_reference``: the legacy format, ``{"epoch",
"model_state", "best_iou"}``). The JAX package's importers
(``tdnet_tpu/utils/torch_import.py``, ``surgery.py``, ``model_store.py``)
read the same dicts; their pytrees come over through ``utils/from_jax.py``.

Tolerances: imports and surgery bitwise; the served stream's logits against
JAX's ``Streamer`` at ``tests/test_torch_stream.py``'s 2e-5. No test opens a
network connection: the store's URLs point at ``file://`` directories here.
The training and validation CLIs on these files: ``test_torch_reference_cli.py``.
"""

import hashlib
import io
import os
import pickle
import re
import urllib.error
import urllib.request
import warnings
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from tdnet_tpu.models.tdnet import TDNetConfig as JaxConfig
from tdnet_tpu.models.teacher import TeacherConfig as JaxTeacherConfig
from tdnet_tpu.nn.resnet import resnet18 as jax_resnet18
from tdnet_tpu.stream.runtime import Streamer as JaxStreamer
from tdnet_tpu.utils import model_store as jax_store
from tdnet_tpu.utils import surgery as jax_surgery
from tdnet_tpu.utils import torch_import as jax_import
from tdnet_tpu.utils.checkpoint import save_best as jax_save_best
from tdnet_tpu_torch.cli import convert, test as cli_test, train as cli_train
from tdnet_tpu_torch.data.png import read_png, write_png
from tdnet_tpu_torch.data.streaming import CITYSCAPES_COLORS, FrameSource, decode_segmap
from tdnet_tpu_torch.models import (PSPNetConfig, Teacher, TeacherConfig, init_pspnet,
                                    init_tdnet, tdnet_config)
from tdnet_tpu_torch.nn import BACKBONES
from tdnet_tpu_torch.stream.runtime import Streamer
from tdnet_tpu_torch.utils import model_store, surgery, torch_import
from tdnet_tpu_torch.utils.checkpoint import load_checkpoint, save_state
from tdnet_tpu_torch.utils.from_jax import (_tree_map, convert_tree, tdnet_state_from_jax,
                                            teacher_state_from_jax)

IN = (65, 129)


class Recording(dict):
    """A state dict that records the keys read through ``[]``."""

    def __init__(self, sd):
        super().__init__(sd)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def counted(sd):
    return {k for k in sd if not k.endswith("num_batches_tracked")}


def assert_same(got: dict, want: dict):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:6]
    bad = [k for k in want if not torch.equal(got[k], want[k])]
    assert not bad, bad[:6]


def td_model(arch, *, backbone, training=False, seed=3, in_size=IN):
    cfg = tdnet_config(arch, in_size=in_size, streaming=not training, backbone=backbone)
    return chip_smoke.seeded(init_tdnet(cfg, torch.Generator().manual_seed(seed)), seed), cfg


def jax_cfg(cfg):
    return JaxConfig(nclass=cfg.nclass, backbone=cfg.backbone, path_num=cfg.path_num,
                     in_size=cfg.in_size, kv_stride=cfg.kv_stride,
                     pool_before_proj=cfg.pool_before_proj, aux=cfg.aux)


def psp_source(backbone, seed=5, aux=True):
    cfg = PSPNetConfig(backbone=backbone, in_size=IN, aux=aux)
    net = chip_smoke.seeded(init_pspnet(cfg, torch.Generator().manual_seed(seed)), seed)
    return net, chip_smoke.reference_state(net, cfg, "psp_source" if aux else "psp101")


@pytest.fixture(autouse=True)
def offline(monkeypatch, tmp_path):
    """Both stores' caches and mirrors are directories of this test."""
    nowhere = f"file://{tmp_path}/no_mirror"
    for store in (model_store, jax_store):
        monkeypatch.setattr(store, "TORCHVISION_URL", nowhere + "/{name}-{sha}.pth")
    monkeypatch.setenv("ENCODING_REPO", nowhere + "/")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))


# --- names: every key JAX reads, and the port's import bitwise JAX's --------------------

@pytest.mark.parametrize("arch,backbone,naming", [
    ("td4-psp18", "resnet10", "testing"), ("td2-psp50", "resnet50", "testing"),
    ("td4-psp18", "resnet10", "training")])
def test_tdnet_names_and_import_match_jax(arch, backbone, naming):
    model, cfg = td_model(arch, backbone=backbone, training=naming == "training")
    ref = chip_smoke.reference_state(model, cfg, naming)
    assert any(k.endswith("num_batches_tracked") for k in ref)
    assert any(k.startswith("auxlayer") for k in ref) == (naming == "training")
    rec = Recording(numpy_sd(ref))
    params = jax_import.tdnet_from_torch(rec, jax_cfg(cfg))
    assert rec.read == counted(ref)
    got = torch_import.tdnet_from_torch(ref, cfg)
    assert_same(got, tdnet_state_from_jax(params, cfg))
    assert_same(got, model.state_dict())


def test_pspnet_and_torchvision_names_match_jax(tmp_path):
    cfg = PSPNetConfig(backbone="resnet101", in_size=IN)
    net = chip_smoke.seeded(init_pspnet(cfg, torch.Generator().manual_seed(2)), 2)
    ref = chip_smoke.reference_state(net, cfg, "psp101")
    rec = Recording(numpy_sd(ref))
    params = {"backbone": jax_import.resnet_from_torch(rec, jax_resnet101(), "pretrained."),
              "head": jax_import.psp_head_from_torch(rec, "head.")}
    assert rec.read == counted(ref)
    got = torch_import.pspnet_from_torch(ref, cfg)
    assert_same(got, convert_tree(params))
    assert_same(got, net.state_dict())

    bb, bcfg = chip_smoke.seeded_model("resnet18", None, seed=4)
    tv = chip_smoke.reference_state(bb, bcfg, "torchvision")
    rec = Recording(numpy_sd({k: v for k, v in tv.items() if not k.startswith("fc.")}))
    jax_import.resnet_from_torch(rec, jax_resnet18(), "")
    assert rec.read == counted(tv) - {"fc.weight", "fc.bias"}
    path = cache_file(tmp_path / "cache", "resnet18", tv, "sha256")
    want = jax_store.load_imagenet_backbone("resnet18", jax_resnet18(), root=str(path.parent))
    got = model_store.load_imagenet_backbone("resnet18", BACKBONES["resnet18"](),
                                             root=str(path.parent))
    assert_same(got, convert_tree(want))
    assert_same(got, bb.state_dict())


def jax_resnet101():
    from tdnet_tpu.nn.resnet import resnet101
    return resnet101()


# --- surgery --------------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 4])
def test_grouped_head_conv_matches_jax(groups):
    w = torch.randn(8, 64, 3, 3, generator=torch.Generator().manual_seed(groups))
    for g in range(groups):
        got = surgery.grouped_head_conv(w, groups, g)
        want = jax_surgery.grouped_head_conv(w.numpy(), groups, g)
        assert got.shape == (8, 64 // groups, 3, 3)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("path_num", [4, 2])
def test_teacher_surgery_matches_jax(path_num):
    _, ref = psp_source("resnet50", seed=7 + path_num)
    tcfg = TeacherConfig(backbone="resnet50", path_num=path_num)
    got = surgery.teacher_from_psp_checkpoint(ref, tcfg)
    want = jax_surgery.teacher_from_psp_checkpoint(
        numpy_sd(ref), JaxTeacherConfig(backbone="resnet50", path_num=path_num))
    assert_same(got, teacher_state_from_jax(want))
    Teacher(tcfg).load_state_dict(got)


def imported(jax_out: dict, parts, path_num) -> dict:
    """The parts of a JAX bootstrap's stacked paths as port state entries."""
    out = {}
    for part in parts:
        for p in range(path_num):
            sub = _tree_map(lambda a: np.asarray(a)[p], jax_out["paths"][part])
            out.update(convert_tree(sub, f"paths.{p}.{part}."))
    return out


@pytest.mark.parametrize("arch,backbone", [("td4-psp18", "resnet10"), ("td2-psp50", "resnet50")])
def test_student_bootstrap_matches_jax(arch, backbone):
    _, ref = psp_source(backbone, seed=11)
    cfg = tdnet_config(arch, in_size=IN, streaming=False, backbone=backbone)
    fresh = init_tdnet(cfg, torch.Generator().manual_seed(1)).state_dict()
    got = surgery.student_bootstrap_from_psp_checkpoint(ref, cfg, fresh)
    jax_out = jax_surgery.student_bootstrap_from_psp_checkpoint(
        numpy_sd(ref), jax_cfg(cfg), {"paths": {"aux": None}, "atn": None})
    parts = ["backbone", "psp", "aux"] + (["head"] if cfg.path_num == 4 else [])
    want = imported(jax_out, parts, cfg.path_num)
    assert set(want) <= set(got)
    assert_same({k: got[k] for k in want}, want)
    assert_same({k: v for k, v in got.items() if k not in want},
                {k: v for k, v in fresh.items() if k not in want})


# --- formats --------------------------------------------------------------------------------

def test_legacy_and_zip_with_and_without_module_prefix(tmp_path):
    model, cfg = td_model("td4-psp18", backbone="resnet10")
    ref = chip_smoke.reference_state(model, cfg, "testing")
    paths = []
    for legacy in (True, False):
        for prefix in ("", "module."):
            path = tmp_path / f"ref_{legacy}_{bool(prefix)}.pkl"
            payload = {"epoch": 1, "model_state": {prefix + k: v for k, v in ref.items()},
                       "best_iou": np.float64(0.5)}
            torch.save(payload, str(path), _use_new_zipfile_serialization=not legacy)
            assert (path.read_bytes()[:2] == b"PK") == (not legacy)
            paths.append(path)
    for path in paths:
        sd = torch_import.load_torch_state(str(path))
        assert_same(torch_import.tdnet_from_torch(sd, cfg), model.state_dict())
        loaded = torch_import.load_tdnet(init_tdnet(cfg, torch.Generator().manual_seed(0)),
                                         str(path))
        assert_same(loaded.state_dict(), model.state_dict())
    payload, fmt = load_checkpoint(str(paths[0]))
    assert fmt == "legacy" and payload["best_iou"] == np.float64(0.5)
    assert load_checkpoint(str(paths[2]))[1] == "zip"


def test_port_and_jax_checkpoints_load_as_before(tmp_path):
    model, cfg = td_model("td4-psp18", backbone="resnet10", training=True)
    path = str(tmp_path / "port.pt")
    save_state(path, model.state_dict())
    fresh = lambda: init_tdnet(cfg, torch.Generator().manual_seed(0))
    assert_same(torch_import.load_tdnet(fresh(), path).state_dict(), model.state_dict())
    jparams = jax_import.tdnet_from_torch(
        numpy_sd(chip_smoke.reference_state(model, cfg, "training")), jax_cfg(cfg))
    jpath = jax_save_best(str(tmp_path), "td4_psp", "cityscapes", step=0, params=jparams,
                          best_iou=0.25)
    assert_same(torch_import.load_tdnet(fresh(), jpath).state_dict(), model.state_dict())
    # a training best model into the streaming twin: the aux heads are left out
    stream_cfg = tdnet_config("td4-psp18", in_size=IN, backbone="resnet10")
    streaming = torch_import.load_tdnet(init_tdnet(stream_cfg, torch.Generator()), path)
    assert_same(streaming.state_dict(),
                {k: v for k, v in model.state_dict().items() if ".aux." not in k})


class Gadget:
    """An object no checkpoint may hold."""


def test_other_objects_are_refused(tmp_path):
    zipped, raw = tmp_path / "gadget.pt", tmp_path / "gadget.pkl"
    torch.save({"model_state": {"a.weight": torch.ones(1)}, "x": Gadget()}, str(zipped))
    with open(raw, "wb") as f:
        pickle.dump({"model_state": {"paths": {}}, "x": Gadget()}, f)
    for path in (zipped, raw):
        with pytest.raises(pickle.UnpicklingError, match=f"{path}: refused"):
            load_checkpoint(str(path))


def test_missing_key_and_input_size_raise():
    model, cfg = td_model("td4-psp18", backbone="resnet10")
    ref = chip_smoke.reference_state(model, cfg, "testing")
    with pytest.raises(KeyError, match="atn3_1.fc.0.conv.bias"):
        torch_import.tdnet_from_torch(
            {k: v for k, v in ref.items() if k != "atn3_1.fc.0.conv.bias"}, cfg)
    other = tdnet_config("td4-psp18", in_size=(97, 193), backbone="resnet10")
    with pytest.raises(ValueError, match=r"\(9, 17\), the config's \(13, 25\)"):
        torch_import.tdnet_from_torch(ref, other)


# --- the slice as a whole -------------------------------------------------------------------

def test_convert_then_serve_matches_jax(tmp_path):
    model, cfg = td_model("td4-psp18", backbone="resnet18", seed=6)
    ref = chip_smoke.reference_state(model, cfg, "testing")
    src, dst = str(tmp_path / "td4-psp18.pkl"), str(tmp_path / "td4-psp18.pt")
    chip_smoke.write_reference(src, ref, "module.")
    convert.main(["--arch", "td4-psp18", "--src", src, "--dst", dst, "--streaming",
                  "--in_size", str(IN[0]), str(IN[1])])
    assert_same(torch.load(dst, weights_only=True)["model_state"], model.state_dict())
    frames = tmp_path / "frames" / "clip"
    frames.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for t in range(8):
        write_png(str(frames / f"f{t}.png"), rng.randint(0, 256, (64, 128, 3)).astype(np.uint8))
    out = tmp_path / "out"
    cli_test.main(["--img_path", str(frames.parent), "--output_path", str(out), "--model",
                   "td4-psp18", "--_td4_psp18_path", dst, "--device", "cpu",
                   "--in_size", str(IN[0]), str(IN[1])])
    port = Streamer(torch_import.load_tdnet(init_tdnet(cfg, torch.Generator()), src))
    jax_stream = JaxStreamer(jax_import.tdnet_from_torch(numpy_sd(ref), jax_cfg(cfg)),
                             jax_cfg(cfg))
    rows = np.arange(IN[0] // 4) * IN[0] // (IN[0] // 4)
    cols = np.arange(IN[1] // 4) * IN[1] // (IN[1] // 4)
    for i, (x, name, folder, _) in enumerate(FrameSource(str(frames.parent), IN)):
        got = port.step(torch.from_numpy(x), timed=False)[0]
        want = np.asarray(jax_stream.step(jnp.asarray(x), timed=False)[0])
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5, err_msg=f"frame {i}")
        pred = got[0].argmax(-1).to(torch.uint8).numpy()
        saved = read_png(str(out / folder / name))
        assert np.array_equal(saved, decode_segmap(pred[rows][:, cols], CITYSCAPES_COLORS))
    assert i == 7


def test_train_reads_converted_sources_as_their_references(tmp_path):
    """``cli.convert``'s teacher (``pspnet_4p``) and bootstrap (``td4_psp
    --bootstrap``) files, read by ``cli.train``'s loaders: the teacher bitwise
    the one made from the reference source; the students the converted file,
    whose imported parts are bitwise those ``cli.train`` makes from the source.
    The JAX package's pickle is refused, naming it."""
    files = {}
    for name, backbone in (("psp18", "resnet18"), ("psp101", "resnet101")):
        files[name] = str(tmp_path / f"{name}.pkl")
        chip_smoke.write_reference(files[name], psp_source(backbone, seed=31)[1])
    size = ["--in_size", str(IN[0]), str(IN[1])]
    convert.main(["--arch", "pspnet_4p", "--src", files["psp101"],
                  "--dst", str(tmp_path / "teacher.pt")])
    convert.main(["--arch", "td4_psp", "--bootstrap", "--src", files["psp18"],
                  "--dst", str(tmp_path / "student.pt"), *size])
    tcfg = TeacherConfig(path_num=4)
    assert_same(cli_train.load_teacher(tcfg, str(tmp_path / "teacher.pt")).state_dict(),
                cli_train.load_teacher(tcfg, files["psp101"]).state_dict())
    cfg = tdnet_config("td4_psp", in_size=IN, streaming=False)
    fresh = lambda: init_tdnet(cfg, torch.Generator().manual_seed(cli_train.SEED))
    got = cli_train.load_student(fresh(), str(tmp_path / "student.pt")).state_dict()
    assert_same(got, torch.load(str(tmp_path / "student.pt"), weights_only=True)["model_state"])
    want = cli_train.load_student(fresh(), files["psp18"]).state_dict()
    parts = (".backbone.", ".psp.", ".aux.", ".head.")
    assert_same({k: v for k, v in got.items() if any(p in k for p in parts)},
                {k: v for k, v in want.items() if any(p in k for p in parts)})
    model, mcfg = td_model("td4_psp", backbone="resnet10", training=True)
    jpath = jax_save_best(str(tmp_path), "td4_psp", "cityscapes", step=0, best_iou=0.25,
                          params=jax_import.tdnet_from_torch(numpy_sd(
                              chip_smoke.reference_state(model, mcfg, "training")), jax_cfg(mcfg)))
    with pytest.raises(ValueError, match=re.escape(f"{jpath}: training.resume is read from a torch")):
        cli_train.load_student(model, jpath)


# --- the store ------------------------------------------------------------------------------

def cache_file(root, name: str, state: dict, algo: str):
    """``state`` saved in ``root`` as ``{name}-{its own digest prefix}.pth``."""
    root.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    torch.save(state, buf)
    data = buf.getvalue()
    path = root / f"{name}-{hashlib.new(algo, data).hexdigest()[:8]}.pth"
    path.write_bytes(data)
    return path


def test_store_finds_verified_files_and_skips_tampered(tmp_path):
    """A file verifies against the digest prefix in its own name; a miss (a
    tampered file, a name not cached) goes to ``offline``'s empty mirror and
    gives None."""
    tv = chip_smoke.reference_state(*chip_smoke.seeded_model("resnet18", None), "torchvision")
    root = tmp_path / "cache"
    path = cache_file(root, "resnet18", tv, "sha256")                 # torchvision: sha256
    zoo = cache_file(root, "resnet50s", {"w": torch.ones(2)}, "sha1")  # encoding zoo: sha1
    assert model_store.get_model_file("resnet18", str(root)) == str(path)
    assert model_store.get_model_file("resnet50s", str(root)) == str(zoo)
    path.write_bytes(path.read_bytes() + b"tampered")
    assert model_store.get_model_file("resnet18", str(root)) is None
    assert model_store.get_model_file("resnet34", str(root)) is None
    assert model_store.load_imagenet_backbone("resnet10", BACKBONES["resnet10"](),
                                              str(root)) is None


def test_store_downloads_from_file_mirrors(tmp_path, monkeypatch):
    payload = b"zoo resnet50s bytes"
    sha = hashlib.sha1(payload).hexdigest()
    repo = tmp_path / "mirror"
    (repo / "encoding" / "models").mkdir(parents=True)
    with zipfile.ZipFile(repo / "encoding" / "models" / f"resnet50-{sha[:8]}.zip", "w") as zf:
        zf.writestr(f"resnet50-{sha[:8]}.pth", payload)
        zf.writestr("../outside.txt", b"never extracted")
    monkeypatch.setitem(model_store.KNOWN_DIGESTS, "resnet50s", ("sha1", sha))
    monkeypatch.setenv("ENCODING_REPO", f"file://{repo}/")
    cache = tmp_path / "cache"
    got = model_store.get_model_file("resnet50s", str(cache))
    assert got == str(cache / f"resnet50s-{sha[:8]}.pth")
    assert open(got, "rb").read() == payload
    assert sorted(os.listdir(cache)) == [os.path.basename(got)]
    assert not (tmp_path / "outside.txt").exists()

    tv = b"torchvision resnet18 bytes"
    sha256 = hashlib.sha256(tv).hexdigest()
    (repo / f"resnet18-{sha256[:8]}.pth").write_bytes(tv)
    monkeypatch.setattr(model_store, "TORCHVISION_URL", f"file://{repo}/{{name}}-{{sha}}.pth")
    monkeypatch.setitem(model_store.KNOWN_DIGESTS, "resnet18", ("sha256", sha256))
    got = model_store.get_model_file("resnet18", str(tmp_path / "cache2"))
    assert open(got, "rb").read() == tv


def test_store_miss_is_bounded_and_logged(tmp_path, monkeypatch):
    """An unreachable source: ``urlopen`` gets ``URL_TIMEOUT`` (no connection is
    made here), and the miss is a warning and ``None``."""
    calls = []

    def unreachable(url, timeout=None):
        calls.append((url, timeout))
        raise urllib.error.URLError("unreachable")
    monkeypatch.setattr(urllib.request, "urlopen", unreachable)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert model_store.get_model_file("resnet34", str(tmp_path / "cache")) is None
    assert calls and calls[0][1] == model_store.URL_TIMEOUT
    assert any("download failed" in str(x.message) for x in w)
