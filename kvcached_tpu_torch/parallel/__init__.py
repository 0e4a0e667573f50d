"""Placement of the engine over several devices (dp replicas so far)."""

from .mesh import Mesh, make_mesh

__all__ = ["Mesh", "make_mesh"]
