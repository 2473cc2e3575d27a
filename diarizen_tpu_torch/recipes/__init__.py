"""Recipe entry points of the port (counterparts of the repository's `recipes/`)."""
