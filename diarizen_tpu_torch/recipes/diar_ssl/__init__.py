"""The DiariZen SSL recipe: checkpoint-averaged inference and DER scoring."""
