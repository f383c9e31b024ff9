"""Frozen copies of the port's sound measuring code (the yardstick)."""
