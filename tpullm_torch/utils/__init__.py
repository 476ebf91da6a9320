"""Host utilities of the tools: the logger and the console."""
