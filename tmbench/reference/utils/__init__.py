"""Pieces of the port's ``utils``, frozen for the plain reference."""
