from .distributed import (  # noqa: F401
    global_tile_mesh,
    initialize,
    shard_scenes,
)
from .sharded import make_tile_mesh, sharded_composite  # noqa: F401
