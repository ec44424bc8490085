"""The port's engine classes (`Sketch`, `Mapper`)."""

from ._sketch import Mapper, Sketch

__all__ = ["Sketch", "Mapper"]
