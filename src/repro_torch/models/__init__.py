"""Model math of the port (paged family)."""
