from .fusion import PathModel
from .gnn import TimeGNN
from .layoutnet import LayoutNet
from .mlp import MLP
from .unet import UNet

__all__ = ["MLP", "LayoutNet", "PathModel", "TimeGNN", "UNet"]
