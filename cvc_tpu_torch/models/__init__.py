"""Model core, generation and parameter I/O of the port."""
