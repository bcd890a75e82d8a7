"""Group streaming on the CPU (``parallel/group_stream.py``,
``stream/parallel_runtime.py:GroupStreamer``): P sub-networks on P devices
(here the CPU, repeated), P frames a super-step.

- Against the JAX package's group step (``tdnet_tpu/parallel/group_stream.py``)
  on the virtual CPU mesh, at ``tests/test_group_stream.py``'s smallest case
  (P = 2, 49x97, ResNet-10, the reference dataflow; one JAX compile): every
  frame's logits within atol and rtol 2e-5, cold frames included.
- Against the port's serial ``Streamer`` for P = 2 and 4, fused trunk or not,
  over two groups and a flushed partial one: bitwise (the same ops in the same
  order on one device), and ``run_pipelined`` too.
- FATD refused with JAX's reason; ``devices=None`` without P cards refused;
  ``SpatialStreamer`` not ported; ``cli.test --parallel group`` end to end, and
  what it refuses.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from tdnet_tpu.models.tdnet import TDNetConfig as JaxConfig
from tdnet_tpu.models.tdnet import init_cache as jax_init_cache
from tdnet_tpu.models.tdnet import init_tdnet as jax_init_tdnet
from tdnet_tpu.parallel.group_stream import make_group_stream_step, make_path_mesh
from tdnet_tpu_torch.models import TDNetConfig, init_tdnet, tdnet_config
from tdnet_tpu_torch.models.fanet_td import FATDConfig, init_fatd
from tdnet_tpu_torch.stream.parallel_runtime import GroupStreamer, SpatialStreamer
from tdnet_tpu_torch.stream.runtime import Streamer, synthetic_frames
from tdnet_tpu_torch.utils.from_jax import tdnet_from_jax
from torch_threads import few_threads  # noqa: F401  (the file runs on two threads)

HW = (49, 97)     # JAX's smallest group-step case
SMALL = (33, 65)  # the port's own comparisons


def _group_outputs(streamer, frames):
    out = []
    for f in frames:
        out += [o for o, _ in streamer.submit(f, timed=False)]
    return out + [o for o, _ in streamer.flush(timed=False)]


def test_group_streamer_matches_jax_group_step():
    p = 2
    jcfg = JaxConfig(nclass=7, backbone="resnet10", path_num=p, in_size=HW, kv_stride=3,
                     aux=False)
    # JAX's own init (jitted: the same values, in half the eager time), as its test takes it
    params = jax.jit(lambda k: jax_init_tdnet(k, jcfg))(jax.random.PRNGKey(0))
    frames = np.random.RandomState(1).randn(2 * p, 1, *HW, 3).astype(np.float32)
    mesh = make_path_mesh(p)
    path_sh, rep = NamedSharding(mesh, P("path")), NamedSharding(mesh, P())
    put = lambda tree, sh: jax.tree.map(lambda x: jax.device_put(x, sh), tree)
    step = make_group_stream_step(jcfg, mesh, donate_cache=False, fused_trunk=False,
                                  stem_impl="xla")
    paths, atn = put(params["paths"], path_sh), put(params["atn"], path_sh)
    cache, want = put(jax_init_cache(jcfg), rep), []
    for g in range(2):
        out, cache = step(paths, atn, cache, jax.device_put(frames[g * p:(g + 1) * p], path_sh))
        want.extend(np.asarray(out))

    cfg = TDNetConfig(nclass=7, backbone="resnet10", path_num=p, in_size=HW, kv_stride=3)
    streamer = GroupStreamer(tdnet_from_jax(params, cfg), fused_trunk=False,
                             devices=["cpu"] * p)
    got = _group_outputs(streamer, [torch.from_numpy(f) for f in frames])
    assert len(got) == len(want) == 2 * p
    for t, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape == (1, *HW, 7)
        np.testing.assert_allclose(a.numpy(), b, atol=2e-5, rtol=2e-5, err_msg=f"frame {t}")


@pytest.mark.parametrize("path_num,fused", [(2, True), (2, False), (4, True), (4, False)])
def test_group_streamer_is_the_serial_stream(path_num, fused):
    """2P + 1 frames: two groups and a flushed group of one frame; and the
    pipelined run's last frame."""
    cfg = TDNetConfig(nclass=7, backbone="resnet10", path_num=path_num, in_size=SMALL,
                      kv_stride=3)
    frames = synthetic_frames(2 * path_num + 1, SMALL, seed=path_num)
    serial = Streamer(init_tdnet(cfg, torch.Generator().manual_seed(0)), fused_trunk=fused)
    want = [serial.step(f, timed=False)[0] for f in frames]
    group = GroupStreamer(init_tdnet(cfg, torch.Generator().manual_seed(0)), fused_trunk=fused,
                          devices=["cpu"] * path_num)
    got = _group_outputs(group, frames)
    assert len(got) == len(want)
    for t, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"frame {t}: {float((a - b).abs().max())}"
    group.reset()
    last, seconds = group.run_pipelined(frames)
    assert torch.equal(last, want[-1]) and seconds > 0


def test_group_streamer_meters_throughput_and_supersteps():
    cfg = TDNetConfig(nclass=7, backbone="resnet10", path_num=2, in_size=SMALL, kv_stride=3)
    group = GroupStreamer(init_tdnet(cfg, torch.Generator().manual_seed(0)),
                          devices=["cpu", "cpu"])
    results = []
    for f in synthetic_frames(1, SMALL) * 9:     # 4 groups of 2 and a flushed 1
        results += group.submit(f)
    results += group.flush()
    assert len(results) == 9
    assert group.superstep_meter.warmup == 3
    ss4, ss5 = group.superstep_meter.times     # the super-steps after the warm-up
    assert group.meter.times == [ss4 / 2, ss4 / 2, ss5 / 2]   # frames 7-9, a share each


def test_group_streaming_refuses_fatd():
    model = init_fatd(FATDConfig(in_size=(64, 128)), torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match="FANet"):
        GroupStreamer(model, devices=["cpu", "cpu"])


def test_group_streaming_needs_its_devices():
    model = init_tdnet(TDNetConfig(nclass=7, backbone="resnet10", path_num=2, in_size=SMALL),
                       torch.Generator().manual_seed(0))
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs 2 devices; have"):
            GroupStreamer(model)
    with pytest.raises(ValueError, match="needs 2 devices; got 3"):
        GroupStreamer(model, devices=["cpu"] * 3)


def test_spatial_streaming_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        SpatialStreamer(None, None)


def _frames_dir(root, n=6, hw=(64, 96)):
    from tdnet_tpu_torch.data.png import write_png
    os.makedirs(root)
    rng = np.random.RandomState(0)
    for i in range(n):
        write_png(os.path.join(root, f"frame_{i:06d}.png"), rng.randint(0, 255, (*hw, 3),
                                                                          np.uint8))
    return root


def test_cli_streams_a_group(tmp_path, capsys):
    """Six frames: a group of four and a flushed tail of two, one PNG each, the
    per-frame numbers labelled as throughput, the super-step's latency."""
    from tdnet_tpu_torch.cli.test import main
    vid = _frames_dir(str(tmp_path / "vid"))
    out = tmp_path / "out"
    main(["--img_path", vid, "--output_path", str(out), "--parallel", "group",
          "--in_size", "33", "65", "--device", "cpu"])
    assert sum(f.endswith(".png") for _, _, fs in os.walk(out) for f in fs) == 6
    stdout = capsys.readouterr().out
    assert "group streaming over 4 devices" in stdout
    assert len(re.findall(r"Frame +\d+ +Throughput/frame=", stdout)) == 6
    assert "Super-step latency" in stdout and "RunningTime/Latency" not in stdout


@pytest.mark.parametrize("argv,error,match", [
    (["--parallel", "spatial"], NotImplementedError, "ROADMAP Queue 1 item 9"),
    (["--parallel", "group", "--model", "td2-fa", "--in_size", "64", "128"], TypeError, "FANet"),
    (["--parallel", "group", "--model", "psp101"], SystemExit, None),
])
def test_cli_refuses_what_group_streaming_does_not_take(argv, error, match, tmp_path):
    from tdnet_tpu_torch.cli.test import main
    vid = _frames_dir(str(tmp_path / "vid"), n=1)
    with pytest.raises(error, match=match):
        main(argv + ["--img_path", vid, "--output_path", str(tmp_path / "out"),
                     "--device", "cpu"])


def test_configs_of_the_cli_models_stream_in_groups():
    """TD4-PSP18 and TD2-PSP50 at their streaming sizes are TDNets the group
    step takes (P devices; one window of W = P - 1 frames)."""
    for arch, p in (("td4-psp18", 4), ("td2-psp50", 2)):
        cfg = tdnet_config(arch, streaming=True)
        assert cfg.path_num == p and cfg.window == p - 1 and cfg.pool_before_proj
