from repro_torch.distributed.sharding import (RULES, SERVE_AXIS, Sharding,
                                              TPGroup, cache_pspec,
                                              gather_cols, on_members,
                                              per_member_bytes,
                                              resolve_pspec, serve_pspec,
                                              serve_tp, shard_put,
                                              sharding_for, tp_group)

__all__ = ["RULES", "SERVE_AXIS", "Sharding", "TPGroup", "cache_pspec",
           "gather_cols", "on_members", "per_member_bytes", "resolve_pspec",
           "serve_pspec", "serve_tp", "shard_put", "sharding_for",
           "tp_group"]
