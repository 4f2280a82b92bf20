"""End-to-end models, serving and weight conversion."""
