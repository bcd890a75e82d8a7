"""Plain tensor ops of the port (NCHW inside)."""

from tdnet_tpu_torch.ops.attention import attention_train, scaled_dot_attention
from tdnet_tpu_torch.ops.conv import (Conv2d, conv2d, init_conv_kaiming, init_conv_msra_out,
                                      normal_)
from tdnet_tpu_torch.ops.norm import (BatchNorm, LayerNorm2d, batch_norm, batch_norm_folded,
                                      batch_norm_train, fold_bn_eval, layer_norm_2d)
from tdnet_tpu_torch.ops.pool import adaptive_avg_pool_multi, grid_subsample, max_pool
from tdnet_tpu_torch.ops.resize import resize_bilinear

__all__ = [
    "attention_train", "scaled_dot_attention", "Conv2d", "conv2d", "init_conv_kaiming", "init_conv_msra_out",
    "normal_",
    "BatchNorm", "LayerNorm2d", "batch_norm", "batch_norm_folded", "batch_norm_train",
    "fold_bn_eval",
    "layer_norm_2d", "adaptive_avg_pool_multi", "grid_subsample", "max_pool",
    "resize_bilinear",
]
