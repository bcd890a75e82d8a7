"""Network modules of the port (NCHW inside)."""

from tdnet_tpu_torch.nn.encoding import (Attention, Encoding, apply_attention,
                                         apply_encoding_cached, apply_encoding_full,
                                         init_attention, init_encoding)
from tdnet_tpu_torch.nn.heads import (FCNHead, PredLayer, apply_fcn_head, apply_pred_layer,
                                      init_fcn_head, init_pred_layer)
from tdnet_tpu_torch.nn.module import Ctx, step_generator
from tdnet_tpu_torch.nn.pyramid import (PSPHead, PyramidPooling, apply_psp_head,
                                        apply_pyramid_pooling, apply_pyramid_pooling_groups,
                                        init_psp_head, init_pyramid_pooling)
from tdnet_tpu_torch.nn.resnet import BACKBONES, ResNet, ResNetConfig, init_resnet

__all__ = [
    "Attention", "Encoding", "apply_attention", "apply_encoding_cached",
    "apply_encoding_full", "init_attention", "init_encoding",
    "FCNHead", "PredLayer", "apply_fcn_head", "apply_pred_layer", "init_fcn_head",
    "init_pred_layer", "Ctx", "step_generator",
    "PSPHead", "PyramidPooling", "apply_psp_head", "apply_pyramid_pooling",
    "apply_pyramid_pooling_groups", "init_psp_head", "init_pyramid_pooling",
    "BACKBONES", "ResNet", "ResNetConfig", "init_resnet",
]
