"""Model configurations of the registry architectures (no model code)."""
