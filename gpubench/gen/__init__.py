"""The benchmark's data and traffic generators (frozen)."""
