"""Classification entry points of the port."""
