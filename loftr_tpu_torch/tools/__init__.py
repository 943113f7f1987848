"""Tools of the port: the synthetic accuracy benchmark and its seed sweep."""
