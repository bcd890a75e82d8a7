"""Checkpoint conversion CLI (``tdnet_tpu/cli/convert.py``).

Converts the reference's PyTorch checkpoints into the port's own format
(``utils/checkpoint.py:save_state``, ``{"model_state": state dict}``), which
``cli.test`` and ``cli.validate`` load, and ``cli.train`` as
``training.resume`` (``--bootstrap``) or ``teacher.teacher_model``
(``pspnet_4p``, ``pspnet_2p``):

  python -m tdnet_tpu_torch.cli.convert --arch td4-psp18 --src td4-psp18.pkl \\
      --dst td4-psp18.pt [--in_size 769 1537] [--streaming]

  # single-path PSPNet -> TDNet bootstrap (channel surgery)
  python -m tdnet_tpu_torch.cli.convert --arch td4_psp --bootstrap --src psp18.pkl ...

  # teacher surgery
  python -m tdnet_tpu_torch.cli.convert --arch pspnet_4p --src psp101.pkl ...
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="checkpoint converter")
    parser.add_argument("--arch", required=True,
                        help="td4-psp18 | td2-psp50 | td4_psp | td2_psp | "
                             "td2_fa | pspnet_4p | pspnet_2p")
    parser.add_argument("--src", required=True, help="torch .pkl checkpoint")
    parser.add_argument("--dst", required=True, help="the port's checkpoint output")
    parser.add_argument("--in_size", type=int, nargs=2, default=[769, 1537])
    parser.add_argument("--streaming", action="store_true",
                        help="use streaming-twin KV settings")
    parser.add_argument("--bootstrap", action="store_true",
                        help="src is a single-path PSPNet; run channel "
                             "surgery into a fresh TDNet")
    parser.add_argument("--nclass", type=int, default=19)
    args = parser.parse_args(argv)
    arch = args.arch.replace("-", "_")
    if arch == "td2_fa":
        raise NotImplementedError("td2_fa is not ported to tdnet_tpu_torch yet")

    from tdnet_tpu_torch.models import TeacherConfig, init_tdnet, tdnet_config
    from tdnet_tpu_torch.utils.checkpoint import save_state
    from tdnet_tpu_torch.utils.surgery import (student_bootstrap_from_psp_checkpoint,
                                               teacher_from_psp_checkpoint)
    from tdnet_tpu_torch.utils.torch_import import (load_torch_state, strip_module_prefix,
                                                    tdnet_from_torch)

    sd = strip_module_prefix(load_torch_state(args.src))
    if arch in ("pspnet_4p", "pspnet_2p"):
        tcfg = TeacherConfig(nclass=args.nclass, path_num=4 if arch == "pspnet_4p" else 2)
        state = teacher_from_psp_checkpoint(sd, tcfg)
    else:
        cfg = tdnet_config(arch, nclass=args.nclass, in_size=tuple(args.in_size),
                           streaming=args.streaming)
        if args.bootstrap:
            fresh = init_tdnet(cfg, torch.Generator().manual_seed(0)).state_dict()
            state = student_bootstrap_from_psp_checkpoint(sd, cfg, fresh)
        else:
            state = tdnet_from_torch(sd, cfg)

    save_state(args.dst, state)
    n = sum(v.numel() for v in state.values())
    print(f"wrote {args.dst}: {n / 1e6:.1f}M params ({arch})")


if __name__ == "__main__":
    main()
