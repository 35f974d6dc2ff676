"""Probe scripts of the voxel path, each runnable with `python -m`."""
