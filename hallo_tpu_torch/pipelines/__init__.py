"""pipelines."""
