"""utils."""
