"""The STT command-line tool of the port."""
