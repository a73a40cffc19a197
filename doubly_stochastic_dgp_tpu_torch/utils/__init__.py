"""Parameter utilities."""
