"""Re-export under the reference's ``ku.gnn_layer`` name (port of
``ku/gnn_layer/__init__.py``)."""

from ku_torch.nn.gnn import GraphConvolutionNetwork
