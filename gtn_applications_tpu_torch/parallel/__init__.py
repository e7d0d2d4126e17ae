from . import mesh
from .mesh import make_mesh, replicate, shard_batch, shard_pytree_batch
