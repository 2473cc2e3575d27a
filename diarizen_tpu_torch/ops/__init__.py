"""Operators: kernel K1 and the host-side numpy stages."""
