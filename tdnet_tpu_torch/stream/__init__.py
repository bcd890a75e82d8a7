"""Streaming runtime."""
