"""Data IO of the port."""
