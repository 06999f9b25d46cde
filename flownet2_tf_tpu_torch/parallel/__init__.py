"""Data parallelism (``mesh``: the process group, ``DevicePrefetcher``) and
spatial tiling of inference (``spatial``)."""
