"""Segments, timelines, annotations and sliding windows (numpy)."""
