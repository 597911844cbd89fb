"""Geometry, pose sampling, point-cloud ops and host I/O."""
