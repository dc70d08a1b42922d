"""convert."""
