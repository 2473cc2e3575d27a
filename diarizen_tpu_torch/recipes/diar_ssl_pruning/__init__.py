"""The DiariZen pruning recipe: take the WavLM trunk out of a fine-tuned
diarization experiment, distill-prune it with HardConcrete gates, and
collapse the gates into a smaller WavLM."""
