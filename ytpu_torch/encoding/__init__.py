"""lib0 wire reading for the port."""
