"""Core library of the port: the clustered FSOFT / iFSOFT on torch and
the numpy host tables it is built from."""
from . import (batched, clusters, indexing, parallel, quadrature,  # noqa: F401
               soft, wigner)
