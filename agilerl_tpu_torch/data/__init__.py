"""Data interfaces of the port."""
