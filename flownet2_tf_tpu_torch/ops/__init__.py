"""Ops of the torch port. Import the submodules (``ops.correlation``,
``ops.flow_warp``, ``ops.resize``, ``ops.sampling``); the package does not
re-export their functions, so a submodule name never resolves to a
function of the same name."""
