"""Dataset tooling of the torch port."""
