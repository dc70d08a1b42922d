"""diffusion."""
