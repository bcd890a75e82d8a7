"""Multi-device training and streaming: the data group (``mesh.py``) and group
streaming (``group_stream.py``)."""
