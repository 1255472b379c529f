"""Counter-based PDE data streams (port of ``repro.data``, PINN part)."""

from repro_torch.data.pipeline import (  # noqa: F401
    pde_collocation_iterator, pde_line_grid_iterator, pde_term_batch_iterator,
    tile_coeff_draws)

__all__ = ["pde_collocation_iterator", "pde_term_batch_iterator",
           "pde_line_grid_iterator", "tile_coeff_draws"]
