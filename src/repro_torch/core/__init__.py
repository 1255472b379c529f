"""TT algebra, the MZI-mesh simulator and the tensor PINN (port of
``repro.core``, serving slice)."""
