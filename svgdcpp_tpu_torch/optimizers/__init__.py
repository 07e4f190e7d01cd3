from .base import Optimizer
from .adam import Adam
from .adagrad import AdaGrad
from .rmsprop import RMSProp
from .optax_adapter import TorchOptimizer
