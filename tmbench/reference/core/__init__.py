"""Pieces of the port's ``core``, frozen for the plain reference."""
