"""TT algebra, the MZI-mesh simulator, the tensor PINN and its losses, FD
derivative estimates, the ZO optimizer and the photonic cost model (port of
``repro.core``)."""
