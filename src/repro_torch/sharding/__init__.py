"""Sharding rules of the port (counterpart of ``repro.sharding``)."""
