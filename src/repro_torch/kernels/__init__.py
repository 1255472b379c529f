"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the device dispatch (``ops``).  Kernels are built from ``csrc/`` on first
use (``_build``), never at import."""
