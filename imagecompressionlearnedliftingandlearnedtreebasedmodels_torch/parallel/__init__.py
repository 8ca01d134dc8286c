"""Spatial tiling of a high-resolution image on one device."""
