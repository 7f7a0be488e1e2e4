"""Exp backends and attention reference math of the port."""
