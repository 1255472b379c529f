"""TT algebra, the MZI-mesh simulator, the tensor PINN and its losses, FD
derivative estimates and the ZO optimizer (port of ``repro.core``)."""
