"""Application backbones (port of ``ku/applications_ext``): the
NobodyConvNet backbones on cuDNN's convolutions."""

from ku_torch.applications_ext.nobody_convnet2d import NobodyConvNet2D
from ku_torch.applications_ext.nobody_convnet3d import NobodyConvNet3D
