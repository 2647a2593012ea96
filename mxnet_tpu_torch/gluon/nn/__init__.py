"""Gluon layers of the port (counterpart of mxnet_tpu/gluon/nn)."""
from .basic_layers import (Activation, BatchNorm, BatchNormReLU, Dense,
                           Dropout, Embedding, Flatten, HybridSequential,
                           LayerNorm)
from .conv_layers import (AvgPool1D, AvgPool2D, AvgPool3D, Conv1D, Conv2D,
                          Conv3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, MaxPool1D, MaxPool2D, MaxPool3D)

__all__ = ["Activation", "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm",
           "BatchNormReLU", "Conv1D", "Conv2D", "Conv3D", "Dense", "Dropout",
           "Embedding", "Flatten", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "HybridSequential", "LayerNorm", "MaxPool1D",
           "MaxPool2D", "MaxPool3D"]
