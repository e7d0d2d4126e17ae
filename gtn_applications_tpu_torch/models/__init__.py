from .rnn import RNN
from .tds import TDS, InstanceNorm, TDSBlock
from .tds2d import TDS2d, TDSBlock2d
