"""Manta/FluidNet cell-type flags (same integer values as the JAX package's
``celltype.py``, so flags arrays move between the two unchanged)."""
from enum import IntEnum


class CellType(IntEnum):
    TypeNone = 0
    TypeFluid = 1
    TypeObstacle = 2
    TypeEmpty = 4
    TypeInflow = 8
    TypeOutflow = 16
    TypeOpen = 32
    TypeStick = 128
    TypeReserved = 256
    TypeZeroPressure = 1 << 15


FLUID = int(CellType.TypeFluid)
OBSTACLE = int(CellType.TypeObstacle)
EMPTY = int(CellType.TypeEmpty)
INFLOW = int(CellType.TypeInflow)
OUTFLOW = int(CellType.TypeOutflow)
STICK = int(CellType.TypeStick)
