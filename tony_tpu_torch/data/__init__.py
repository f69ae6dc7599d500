"""Data plane of the port: TONYTOK shards, the replay primitives and the
token loader (own copies of ``tony_tpu/data``'s, file-compatible with them)."""
