from .exceptions import DimensionMismatchError, SVGDError, UnsetError
from .types import ParticleStore, PrecisionPolicy, as_coords, as_store
