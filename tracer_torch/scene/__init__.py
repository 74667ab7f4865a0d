"""Sphere scenes."""
