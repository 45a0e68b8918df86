"""Host utilities of the port (numpy / pure Python)."""
