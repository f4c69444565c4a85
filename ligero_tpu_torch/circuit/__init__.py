from .arithmetic import ArithmeticCircuit, filter_constants
from .expression import Expression

__all__ = ["ArithmeticCircuit", "filter_constants", "Expression"]
