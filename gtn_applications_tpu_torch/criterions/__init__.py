from .asg import ASG, create_transitions_graph
from .base import Criterion
from .ctc import CTC
from .stc import STC
from .transducer import Transducer
