"""models."""
