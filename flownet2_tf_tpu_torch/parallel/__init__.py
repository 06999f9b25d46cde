"""Device staging of host batches (``mesh.DevicePrefetcher``); data
parallelism is not ported yet (ROADMAP Queue 1 item 15)."""
