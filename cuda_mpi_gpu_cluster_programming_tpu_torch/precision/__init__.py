"""Dtype policies."""
