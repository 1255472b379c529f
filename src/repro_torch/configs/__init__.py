"""Model configurations of the port (``repro.configs``, PINN part)."""
