"""Data helpers of the port: the streaming frame source and palettes."""
