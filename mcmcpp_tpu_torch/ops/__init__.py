"""Elementwise and selection primitives of the stretch move (torch)."""
