"""Cluster-watch support: so far :mod:`.adapt`, the warm-start
adaptation behind ``api.optimize_delta`` (evict dead brokers from the
previous plan, keep surviving replicas in place, fill the holes
rack-aware)."""
