"""Core library of the port: the clustered FSOFT / iFSOFT on torch and
the numpy host tables it is built from."""
from . import batched, clusters, indexing, quadrature, soft, wigner  # noqa: F401
