"""Model definitions with the reference torch key layouts."""
