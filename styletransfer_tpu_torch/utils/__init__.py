"""Logging and image IO."""
