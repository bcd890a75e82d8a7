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
                        help="multi-device streaming (not ported yet)")
    args = parser.parse_args(argv)
    if args.parallel:
        raise NotImplementedError(f"--parallel {args.parallel} is not ported to tdnet_tpu_torch")

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
    runner = (FrameRunner if args.model == "psp101" else Streamer)(
        model.to(device), dtype=dtype, stem_impl=args.stem_impl)
    os.makedirs(args.output_path, exist_ok=True)
    # quarter-resolution nearest-neighbour sampling grid
    rows = np.arange(in_size[0] // 4) * in_size[0] // (in_size[0] // 4)
    cols = np.arange(in_size[1] // 4) * in_size[1] // (in_size[1] // 4)

    for i, (x, img_name, folder, _) in enumerate(FrameSource(args.img_path, in_size)):
        out, dt = runner.step(torch.from_numpy(x))
        if not args.no_save:
            pred = out[0].argmax(-1).to(torch.uint8).cpu().numpy()
            save_dir = os.path.join(args.output_path, folder)
            os.makedirs(save_dir, exist_ok=True)
            write_png(os.path.join(save_dir, img_name), decode_segmap(pred[rows][:, cols], palette))
        print(" Frame {0:2d}   RunningTime/Latency={1:3.5f} s".format(i + 1, dt))

    meter = runner.meter
    print("---------------------")
    print(" Model: {0:s}".format(args.model))
    print(" Average  RunningTime/Latency={0:3.5f} s  ({1:.1f} FPS)".format(meter.avg, meter.fps))
    print("---------------------")


if __name__ == "__main__":
    main()
