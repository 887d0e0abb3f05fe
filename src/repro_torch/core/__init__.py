"""Host-side index structures (numpy) and the torch row scorer."""
