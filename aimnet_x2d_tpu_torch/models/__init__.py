from .gnn import GNN, GNNConfig, GNNOutput
from .layers import Linear, LinearBlock, MultiLayerPerceptron, ShellConvolutionLayer
from .pooling import POOLING_TYPES

__all__ = [
    "GNN",
    "GNNConfig",
    "GNNOutput",
    "Linear",
    "LinearBlock",
    "MultiLayerPerceptron",
    "ShellConvolutionLayer",
    "POOLING_TYPES",
]
