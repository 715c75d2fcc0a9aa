"""Data builders of the port (counterparts of the repository's ``scripts/``)."""
