"""Host-side constants shared by the port's device code."""
