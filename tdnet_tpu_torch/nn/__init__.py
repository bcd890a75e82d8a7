"""Network modules of the port (eval mode, NCHW inside)."""

from tdnet_tpu_torch.nn.encoding import (Attention, Encoding, apply_attention,
                                         apply_encoding_cached, apply_encoding_full,
                                         init_attention, init_encoding)
from tdnet_tpu_torch.nn.heads import FCNHead, apply_fcn_head, init_fcn_head
from tdnet_tpu_torch.nn.pyramid import (PyramidPooling, apply_pyramid_pooling,
                                        init_pyramid_pooling)
from tdnet_tpu_torch.nn.resnet import BACKBONES, ResNet, ResNetConfig, init_resnet

__all__ = [
    "Attention", "Encoding", "apply_attention", "apply_encoding_cached",
    "apply_encoding_full", "init_attention", "init_encoding",
    "FCNHead", "apply_fcn_head", "init_fcn_head",
    "PyramidPooling", "apply_pyramid_pooling", "init_pyramid_pooling",
    "BACKBONES", "ResNet", "ResNetConfig", "init_resnet",
]
