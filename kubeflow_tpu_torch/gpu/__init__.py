"""The H100 node table (gpu/topology.py)."""
