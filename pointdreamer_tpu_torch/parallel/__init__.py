from .mesh import (COLLECTIVES, Mesh, make_mesh, reset_collectives,
                   shard_params_dp_tp, shard_views, unet_shard_rule)

__all__ = ["COLLECTIVES", "Mesh", "make_mesh", "reset_collectives",
           "shard_params_dp_tp", "shard_views", "unet_shard_rule"]
