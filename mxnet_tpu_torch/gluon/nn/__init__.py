"""Gluon layers of the port (counterpart of mxnet_tpu/gluon/nn)."""
from .activations import ELU, GELU, SELU, LeakyReLU, PReLU, SiLU, Swish
from .basic_layers import (Activation, BatchNorm, BatchNormReLU, Concatenate,
                           Dense, Dropout, Embedding, Flatten, GroupNorm,
                           HybridConcatenate, HybridLambda, HybridSequential,
                           Identity, InstanceNorm, Lambda, LayerNorm,
                           Sequential, SyncBatchNorm)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D,
                          Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                          Conv3DTranspose, DeformableConvolution,
                          GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D,
                          GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
                          MaxPool1D, MaxPool2D, MaxPool3D,
                          ModulatedDeformableConvolution, PixelShuffle1D,
                          PixelShuffle2D, PixelShuffle3D, ReflectionPad2D)
from ..block import HybridBlock

__all__ = ["Activation", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "BatchNormReLU", "Concatenate", "Conv1D", "Conv1DTranspose",
           "Conv2D", "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
           "DeformableConvolution", "Dense", "Dropout", "ELU", "Embedding",
           "Flatten", "GELU", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "GroupNorm", "HybridBlock", "HybridConcatenate",
           "HybridLambda", "HybridSequential", "Identity", "InstanceNorm",
           "Lambda", "LayerNorm", "LeakyReLU", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "ModulatedDeformableConvolution", "PReLU",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "ReflectionPad2D", "SELU", "Sequential", "SiLU", "Swish",
           "SyncBatchNorm"]
