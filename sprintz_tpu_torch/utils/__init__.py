"""Host and device utilities of the port: debug dumps, bit helpers,
device timing and tracing."""
