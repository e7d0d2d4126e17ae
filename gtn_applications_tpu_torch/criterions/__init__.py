from .asg import ASG
from .base import Criterion
from .ctc import CTC
from .stc import STC
from .transducer import Transducer
