"""The DiariZen SSL recipe: training and validation, and checkpoint-averaged
inference and DER scoring."""
