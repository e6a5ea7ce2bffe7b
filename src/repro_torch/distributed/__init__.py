"""Splitting the switch axis over a mesh of torch devices: the counterpart
of ``repro.distributed`` (its multi-switch half, ``sharding.py:255-373``).

One process drives every device of the mesh, as ``repro``'s ``shard_map``
does from one controller; a device list may name one device more than once.
"""
