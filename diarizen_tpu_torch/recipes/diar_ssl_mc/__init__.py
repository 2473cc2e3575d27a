"""The multi-channel DiariZen recipe: training and validation, and
checkpoint-averaged inference and DER scoring."""
