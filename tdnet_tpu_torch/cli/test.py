"""Streaming inference CLI for the TDNet models, TD2-FANet and the PSPNet-101
baseline on one device.

Mirrors ``python Testing/test.py`` (reference Testing/test.py:85-110):
round-robin streaming over a frame directory (``--model psp101``: one
PSPNet-101 forward per frame), colorized quarter-resolution PNG outputs, and
per-frame latency with the 6-frame warm-up excluded. Frames are read and
outputs written by ``data/png.py`` (no image library). ``--stem_impl fused``
runs the deep-base stems (TD2-PSP50, PSP-101) through the fused stem kernel.
The checkpoint path of the model (``--_td4_psp18_path`` ...) may hold the
reference's file (TD4-PSP18 and TD2-PSP50 in the Testing twin's naming,
TD2-FANet in its training naming, PSP-101 as ``pretrained.*`` and ``head.*``),
the port's own (``cli/convert.py``) or, for a TDNet or TD2-FANet, the JAX
package's (``utils/torch_import.py:load_tdnet``, ``load_fatd``); with no file
the weights are random (seed 0). ``--model td2-fa`` streams TD2-FANet
(``models/fanet_td.py``; its LayerNorm fixes the input size, 768x1536 for the
reference's files).

    python -m tdnet_tpu_torch.cli.test --img_path frames/ --output_path out/ \\
        --model td2-psp50 --device cuda --dtype bfloat16 --stem_impl fused

``--parallel group`` streams a TDNet over P devices, one sub-network each
(``stream/parallel_runtime.py:GroupStreamer``): the first P cards, or
``--device`` repeated where fewer are there (one card, or the CPU), P frames a
super-step; each frame's line gives its share of the super-step's time
(Throughput/frame), the summary the super-step's latency. ``--parallel
spatial`` and group streaming of TD2-FANet are not ported.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

MODELS = ("td4-psp18", "td2-psp50", "td2-fa", "psp101")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Params")
    parser.add_argument("--img_path", nargs="?", type=str, default="./data/vid1",
                        help="Path_to_Frame")
    parser.add_argument("--output_path", nargs="?", type=str, default="./output/",
                        help="Path_to_Save")
    parser.add_argument("--_td4_psp18_path", nargs="?", type=str,
                        default="./checkpoint/td4-psp18.pkl")
    parser.add_argument("--_td2_psp50_path", nargs="?", type=str,
                        default="./checkpoint/td2-psp50.pkl")
    parser.add_argument("--_td2_fa_path", nargs="?", type=str,
                        default="./checkpoint/td2-fa.pkl")
    parser.add_argument("--_psp101_path", nargs="?", type=str,
                        default="./checkpoint/psp101.pkl")
    parser.add_argument("--model", nargs="?", type=str, default="td4-psp18", choices=MODELS,
                        help=f"model in [{', '.join(MODELS)}]")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--in_size", type=int, nargs=2, default=[769, 1537])
    parser.add_argument("--stem_impl", type=str, default="plain", choices=["plain", "fused"],
                        help="'fused': the deep-base stem's tail through the fused kernel "
                             "(TD2-PSP50, PSP-101; eval)")
    parser.add_argument("--no_save", action="store_true")
    parser.add_argument("--dataset", type=str, default="cityscapes",
                        choices=["cityscapes", "camvid", "nyud2", "nyudv2"],
                        help="sets the class count and output palette")
    parser.add_argument("--nclass", type=int, default=None,
                        help="override the class count")
    parser.add_argument("--parallel", type=str, default=None, choices=["group", "spatial"],
                        help="multi-device streaming: 'group' puts one sub-network on each of "
                             "P devices and runs P frames a super-step; 'spatial' is not ported")
    args = parser.parse_args(argv)
    if args.parallel == "spatial":
        from tdnet_tpu_torch.stream.parallel_runtime import SPATIAL
        raise NotImplementedError(SPATIAL)
    if args.parallel and args.model == "psp101":
        parser.error("--parallel targets the TDNet PSP students; psp101 is not supported")

    from tdnet_tpu_torch.data.png import write_png
    from tdnet_tpu_torch.data.streaming import DATASET_META, FrameSource, decode_segmap
    from tdnet_tpu_torch.models import PSPNetConfig, init_model, init_pspnet, tdnet_config
    from tdnet_tpu_torch.stream.runtime import FrameRunner, Streamer
    from tdnet_tpu_torch.utils.torch_import import load_fatd, load_pspnet, load_tdnet

    in_size = tuple(args.in_size)
    nclass, palette = DATASET_META[args.dataset]
    nclass = args.nclass or nclass
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    ckpt_path = {"td4-psp18": args._td4_psp18_path,
                 "td2-psp50": args._td2_psp50_path,
                 "td2-fa": args._td2_fa_path,
                 "psp101": args._psp101_path}[args.model]
    gen = torch.Generator().manual_seed(0)
    if args.model == "psp101":
        cfg = PSPNetConfig(nclass=nclass, backbone="resnet101", in_size=in_size)
        model, load = init_pspnet(cfg, gen), load_pspnet
    else:
        cfg = tdnet_config(args.model, nclass=nclass, in_size=in_size, streaming=True)
        model = init_model(cfg, gen)
        load = load_fatd if args.model == "td2-fa" else load_tdnet
    if ckpt_path and os.path.isfile(ckpt_path):
        print(f"Loading pretrained model from '{ckpt_path}'")
        load(model, ckpt_path)
    else:
        print(f"No pretrained found at '{ckpt_path}'")
    if args.parallel == "group":
        from tdnet_tpu_torch.stream.parallel_runtime import GroupStreamer
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        devices = None if cards >= cfg.path_num else [device] * cfg.path_num
        runner = GroupStreamer(model, dtype=dtype, stem_impl=args.stem_impl, devices=devices)
        print(f"group streaming over {cfg.path_num} devices: "
              f"{', '.join(str(d) for d in runner.devices)}")
    else:
        runner = (FrameRunner if args.model == "psp101" else Streamer)(
            model.to(device), dtype=dtype, stem_impl=args.stem_impl)
    os.makedirs(args.output_path, exist_ok=True)
    # quarter-resolution nearest-neighbour sampling grid
    rows = np.arange(in_size[0] // 4) * in_size[0] // (in_size[0] // 4)
    cols = np.arange(in_size[1] // 4) * in_size[1] // (in_size[1] // 4)

    group = args.parallel == "group"
    # group mode: a frame's number is its share of a super-step's time, not a latency
    label = "Throughput/frame" if group else "RunningTime/Latency"
    waiting = []   # (img_name, folder) of frames whose group has not run yet
    emitted = 0

    def emit(out, dt):
        nonlocal emitted
        img_name, folder = waiting.pop(0)
        emitted += 1
        if not args.no_save:
            pred = out[0].argmax(-1).to(torch.uint8).cpu().numpy()
            save_dir = os.path.join(args.output_path, folder)
            os.makedirs(save_dir, exist_ok=True)
            write_png(os.path.join(save_dir, img_name), decode_segmap(pred[rows][:, cols], palette))
        print(" Frame {0:2d}   {1:s}={2:3.5f} s".format(emitted, label, dt))

    for x, img_name, folder, _ in FrameSource(args.img_path, in_size):
        waiting.append((img_name, folder))
        x = torch.from_numpy(x)
        for out, dt in runner.submit(x) if group else [runner.step(x)]:
            emit(out, dt)
    for out, dt in runner.flush() if group else []:
        emit(out, dt)

    meter = runner.meter
    print("---------------------")
    print(" Model: {0:s}".format(args.model))
    print(" Average  {0:s}={1:3.5f} s  ({2:.1f} FPS)".format(label, meter.avg, meter.fps))
    if group:
        print(" Average  Super-step latency={0:3.5f} s  ({1:d} frames per super-step)".format(
            runner.superstep_meter.avg, cfg.path_num))
    print("---------------------")


if __name__ == "__main__":
    main()
