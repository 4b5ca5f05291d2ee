"""Launchers."""
