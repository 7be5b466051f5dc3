"""Numerics substrate + tracking renders."""
