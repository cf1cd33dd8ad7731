"""Multi-device layers: the row-sharded embedding lookup (`parallel.embedding`)."""
