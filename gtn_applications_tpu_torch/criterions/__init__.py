from .base import Criterion
from .ctc import CTC
