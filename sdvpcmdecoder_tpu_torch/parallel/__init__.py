"""Device grid / sharding utilities for multi-GPU batch decode."""
from .mesh import (decode_mesh, shard_captures, chunk_lines_with_halo,
                   multichip_decode_step)  # noqa: F401
