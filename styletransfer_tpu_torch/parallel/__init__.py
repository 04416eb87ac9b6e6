"""Feeding the device: host -> device prefetch."""
