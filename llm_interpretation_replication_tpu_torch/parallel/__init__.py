"""Device meshes: only the shape arithmetic the plan search reads
(``mesh.enumerate_mesh_shapes``, ``mesh.mesh_shape_for``).  Building a
mesh, sharding, ring attention, Ulysses and the pipeline are not ported
yet (ROADMAP.md queue 1, 'Parallel and training')."""

from .mesh import enumerate_mesh_shapes, mesh_shape_for

__all__ = ["enumerate_mesh_shapes", "mesh_shape_for"]
