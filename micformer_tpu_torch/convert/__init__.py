"""Weight conversion into the port."""
