"""Weight bridge and helpers."""
