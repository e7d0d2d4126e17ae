from .tds import InstanceNorm
from .tds2d import TDS2d, TDSBlock2d
