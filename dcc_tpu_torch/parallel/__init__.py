"""Data parallelism over ranks of ``torch.distributed`` (counterpart of
:mod:`dcc_tpu.parallel`): the launch layer and control plane
(:mod:`.distributed`) and the env axis split over the ranks (:mod:`.mesh`)."""

from . import distributed
from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "distributed", "make_mesh"]
