"""The plain reference of the configurations' retrieval, and the comparison."""
