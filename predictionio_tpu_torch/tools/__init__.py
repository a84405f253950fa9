"""Operator scripts of the port (counterparts of the repository's
``scripts/``)."""
