"""Inference drivers."""
