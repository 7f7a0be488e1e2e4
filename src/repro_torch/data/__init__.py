"""Synthetic training data of the port (see ``synthetic``)."""

from .synthetic import StructuredLM, SyntheticLM

__all__ = ["StructuredLM", "SyntheticLM"]
